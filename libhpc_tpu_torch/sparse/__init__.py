from libhpc_tpu_torch.sparse.coo import COO  # noqa: F401
from libhpc_tpu_torch.sparse.csr import CSR  # noqa: F401
from libhpc_tpu_torch.sparse.bsr import BSR  # noqa: F401
from libhpc_tpu_torch.sparse.ell import ELL  # noqa: F401
from libhpc_tpu_torch.sparse.dia import DIA  # noqa: F401
from libhpc_tpu_torch.sparse.hybrid import BandedHybrid  # noqa: F401
from libhpc_tpu_torch.sparse.grid import BlockGrid, NestedGrid  # noqa: F401
from libhpc_tpu_torch.sparse.bell import BELL  # noqa: F401
from libhpc_tpu_torch.sparse.sbell import SBELL  # noqa: F401
from libhpc_tpu_torch.sparse.auto import auto_format  # noqa: F401
