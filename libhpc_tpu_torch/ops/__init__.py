from libhpc_tpu_torch.ops import spmv, spmm, solver  # noqa: F401
from libhpc_tpu_torch.ops import spgemm, spgemm_bsr  # noqa: F401
from libhpc_tpu_torch.ops import multigrid, precision  # noqa: F401
from libhpc_tpu_torch.ops import spmv_sbell, far_sbell  # noqa: F401
from libhpc_tpu_torch.ops import spmv_dia, spmv_sell, sellp  # noqa: F401
from libhpc_tpu_torch.ops import histogram, sort, sort_merge  # noqa: F401
from libhpc_tpu_torch.ops import scan, sort_merge_kv  # noqa: F401
from libhpc_tpu_torch.ops import reduce, transpose, matmul, stencil  # noqa: F401
