"""libhpc_tpu_torch — the PyTorch/CUDA port of libhpc_tpu for one NVIDIA H100.

The JAX package ``libhpc_tpu`` is the reference; each module here names its
counterpart there and keeps its function names, argument order, container
fields, shapes and dtypes. This package imports torch, numpy and scipy and
never jax. Hand-written CUDA kernels live in ``csrc/`` and are built with
nvcc at their first launch (``ops/_cuda_utils.py``); on CPU tensors every
kernel wrapper runs its plain PyTorch version instead.

Ported so far: the sparse-solve main path — scipy matrix -> SBELL container
-> SBELL SpMV (near kernel + FarPane far kernel) -> CG in pane layout — its
CSR half (``csr_spmv`` + the Krylov solvers), and the rest of the SpMV
family behind ``sparse.auto_format``: DIA (plain and the streaming DIA
kernel), SELL and SELL-P; the sort family: the merge-path u32 sort and
its key-value form (argsort), the radix module, the histogram and the
exclusive scans; the dense-array, stencil and sparse-grid layer: row
sums, the tiled transpose, the tiled matmul, the ghost-cell stencils with
the halo box blur, Morton codes and the hierarchical sparse grids; and the
micro-architecture suites with the timing harness.

Entry points run on the card: builders build on the host and move their
containers to ``device`` (default ``"cuda"``), and a numpy input to an op
goes to ``device``; a torch tensor stays on its own device, so a CPU
tensor or ``device="cpu"`` asks for the CPU.

- ``libhpc_tpu_torch.sparse`` — ``CSR``, ``ELL``, ``DIA``, ``SBELL`` (with
  its ``FarPane`` and ``FarBlocks`` far sets), ``auto_format``, and the
  sparse grids ``BlockGrid`` and ``NestedGrid``.
- ``libhpc_tpu_torch.ops``    — ``spmv`` (``csr_spmv``, ``ell_spmv``,
  ``far_spmv``, ``dia_spmv``, ``dia_spmv_t``), the kernel wrappers
  ``spmv_sbell``, ``far_sbell``, ``spmv_dia`` (``DiaPallas``),
  ``spmv_sell`` (``SELL``, ``SELLSplit``) and ``sellp`` (``SELLP``),
  ``solver``, ``sort_merge`` (``merge_sort_u32``), ``sort_merge_kv``
  (``merge_sort_kv_u32``, ``merge_argsort_u32``), ``sort`` (``sort_u32``,
  ``argsort_u32``, ``radix_sort_pipeline``, ``bitonic_sort``),
  ``histogram`` (``histogram_pallas``), ``scan`` (``exclusive_scan``,
  ``inclusive_scan``, ``exclusive_scan_pallas``), ``reduce``
  (``segment_sum``/``_max``/``_min``, ``tree_reduce_sum``,
  ``row_sum_pallas``), ``transpose`` (``transpose``,
  ``transpose_pallas``), ``matmul`` (``matmul_pallas``) and ``stencil``
  (``blur_x``, ``blur_y``, ``blur2d``, ``blur2d_pallas``,
  ``poisson5_apply``, ``poisson7_apply`` and the ``*_halo`` stencils).
- ``libhpc_tpu_torch.containers`` — ``HaloArray``, the ghost-cell array.
- ``libhpc_tpu_torch.utils``  — Morton codes (``utils.morton``).
- ``libhpc_tpu_torch.bench``  — the deterministic matrix generators, the
  timing harness (``bench.harness``: ``time_iterated`` and the
  device-memory probes), the overlap sweep (``bench.overlap_chip``) and
  the micro-architecture probes (``bench.microarch``).
"""

__version__ = "0.1.0"

from libhpc_tpu_torch.ops import spmv, solver  # noqa: F401
from libhpc_tpu_torch.ops import spmv_sbell, far_sbell  # noqa: F401
from libhpc_tpu_torch.ops import spmv_dia, spmv_sell, sellp  # noqa: F401
from libhpc_tpu_torch.ops import histogram, sort, sort_merge  # noqa: F401
from libhpc_tpu_torch.ops import scan, sort_merge_kv  # noqa: F401
from libhpc_tpu_torch.ops import reduce, transpose, matmul  # noqa: F401
from libhpc_tpu_torch.ops import stencil  # noqa: F401
from libhpc_tpu_torch.containers import HaloArray  # noqa: F401
from libhpc_tpu_torch.sparse.csr import CSR  # noqa: F401
from libhpc_tpu_torch.sparse.ell import ELL  # noqa: F401
from libhpc_tpu_torch.sparse.dia import DIA  # noqa: F401
from libhpc_tpu_torch.sparse.sbell import SBELL  # noqa: F401
from libhpc_tpu_torch.sparse.auto import auto_format  # noqa: F401
from libhpc_tpu_torch.sparse.grid import BlockGrid, NestedGrid  # noqa: F401
