from libhpc_tpu_torch.ops import spmv, solver  # noqa: F401
from libhpc_tpu_torch.ops import spmv_sbell, far_sbell  # noqa: F401
from libhpc_tpu_torch.ops import spmv_dia, spmv_sell, sellp  # noqa: F401
from libhpc_tpu_torch.ops import histogram, sort, sort_merge  # noqa: F401
from libhpc_tpu_torch.ops import scan, sort_merge_kv  # noqa: F401
