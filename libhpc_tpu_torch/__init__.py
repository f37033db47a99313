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
micro-architecture suites with the timing harness; the solvers on the
main path: aggregation AMG on the SBELL kernel, geometric multigrid and
the compensated reductions; the other sparse formats: COO, BSR,
BELL and the banded hybrid with their SpMV and SpMM; SpGEMM (scalar:
ELL-expanded, row-blocked and windowed; and on 8 x 8 blocks); and the
utilities (configs, validation, checkpoints, profiling ranges), the
binding of the native host runtime and the benchmark byte models; and
the distributed layer on ``torch.distributed`` (``parallel``: meshes,
collectives, halo exchange, the row- and 2-D-partitioned SpMVs with their
CG and AMG-PCG, the distributed stencils), its dry run (``dryrun``) and
its overlap and weak-scaling benches.

Entry points run on the card: builders build on the host and move their
containers to ``device`` (default ``"cuda"``), and a numpy input to an op
goes to ``device``; a torch tensor stays on its own device, so a CPU
tensor or ``device="cpu"`` asks for the CPU.

- ``libhpc_tpu_torch.sparse`` — ``COO``, ``CSR``, ``BSR``, ``ELL``,
  ``DIA``, ``BandedHybrid``, ``BELL``, ``SBELL`` (with its ``FarPane`` and
  ``FarBlocks`` far sets), ``auto_format``, and the sparse grids
  ``BlockGrid`` and ``NestedGrid``.
- ``libhpc_tpu_torch.ops``    — ``spmv`` (``csr_spmv``, ``ell_spmv``,
  ``bsr_spmv``, ``bell_spmv``, ``far_spmv``, ``coo_spmv``, ``dia_spmv``,
  ``csr_spmv_t``, ``dia_spmv_t``, ``hybrid_spmv``), ``spmm``
  (``csr_spmm``, ``ell_spmm``, ``bsr_spmm``), ``multigrid`` (the
  vertex- and cell-centred V-cycles, ``mg_solve``, ``mg_solve_cc``),
  ``multigrid_sbell`` (``amg_setup``, ``amg_vcycle``, ``amg_pcg``),
  ``precision`` (``sum_compensated``, ``dot_compensated``,
  ``norm2_compensated``), ``spgemm`` (``spgemm``, ``spgemm_csr``,
  ``spgemm_blocked``, ``spgemm_windowed``, ``spgemm_expansion_size``),
  ``spgemm_bsr`` (``spgemm_bsr``, ``spgemm_bsr_scipy``), the kernel
  wrappers
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
- ``libhpc_tpu_torch.utils``  — Morton codes (``utils.morton``), the
  config dataclasses (``utils.config``), CSR validation and
  ``debug_nans`` (``utils.validate``), ``.npz`` checkpoints
  (``utils.checkpoint``) and profiling ranges and traces
  (``utils.profiling``).
- ``libhpc_tpu_torch.runtime`` — ``runtime.native``, the ctypes binding
  of the repo's ``native/`` host library (arena pool, MatrixMarket
  loader, host Morton encode, self-test), built into ``_build/native``.
- ``libhpc_tpu_torch.parallel`` — ``mesh`` (``make_mesh_1d``,
  ``make_mesh_2d``, the rank launcher ``launch`` / ``RankPool``),
  ``collectives``, ``halo``, ``dist_spmv`` (``DistCSR``), ``dist_dia``
  (``DistDIA``), ``dist2d`` (``Dist2DCSR``), ``dist_stencil``,
  ``dist_sbell`` (``DistSBELL``), ``dist_amg`` and ``programs``; and
  ``libhpc_tpu_torch.dryrun`` (``dryrun_multichip``).
- ``libhpc_tpu_torch.examples`` — ``amg_solve``, ``distributed_spmv``,
  ``poisson_cg`` and ``multigrid_demo``, run as
  ``python -m libhpc_tpu_torch.examples.<name>``.
- ``libhpc_tpu_torch.bench``  — the deterministic matrix generators, the
  timing harness (``bench.harness``: ``time_iterated``, the
  device-memory probes and the SpMV byte models), the overlap sweep (``bench.overlap_chip``),
  the micro-architecture probes (``bench.microarch``) and the distributed
  benches (``bench.overlap``, ``bench.scaling``).
"""

__version__ = "0.1.0"

from libhpc_tpu_torch.ops import spmv, spmm, solver  # noqa: F401
from libhpc_tpu_torch.ops import multigrid, precision  # noqa: F401
from libhpc_tpu_torch.ops import spmv_sbell, far_sbell  # noqa: F401
from libhpc_tpu_torch.ops import spmv_dia, spmv_sell, sellp  # noqa: F401
from libhpc_tpu_torch.ops import histogram, sort, sort_merge  # noqa: F401
from libhpc_tpu_torch.ops import scan, sort_merge_kv  # noqa: F401
from libhpc_tpu_torch.ops import reduce, transpose, matmul  # noqa: F401
from libhpc_tpu_torch.ops import stencil  # noqa: F401
from libhpc_tpu_torch.containers import HaloArray  # noqa: F401
from libhpc_tpu_torch.sparse.csr import CSR  # noqa: F401
from libhpc_tpu_torch.sparse.coo import COO  # noqa: F401
from libhpc_tpu_torch.sparse.bsr import BSR  # noqa: F401
from libhpc_tpu_torch.sparse.ell import ELL  # noqa: F401
from libhpc_tpu_torch.sparse.dia import DIA  # noqa: F401
from libhpc_tpu_torch.sparse.sbell import SBELL  # noqa: F401
from libhpc_tpu_torch.sparse.auto import auto_format  # noqa: F401
from libhpc_tpu_torch.sparse.grid import BlockGrid, NestedGrid  # noqa: F401
