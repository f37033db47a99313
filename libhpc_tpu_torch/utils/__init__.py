from libhpc_tpu_torch.utils.morton import morton2d_encode, morton2d_decode  # noqa: F401
from libhpc_tpu_torch.utils.config import KernelConfig  # noqa: F401
