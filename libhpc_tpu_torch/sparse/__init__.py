from libhpc_tpu_torch.sparse.csr import CSR  # noqa: F401
from libhpc_tpu_torch.sparse.ell import ELL  # noqa: F401
from libhpc_tpu_torch.sparse.dia import DIA  # noqa: F401
from libhpc_tpu_torch.sparse.sbell import SBELL  # noqa: F401
from libhpc_tpu_torch.sparse.auto import auto_format  # noqa: F401
