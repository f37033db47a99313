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
kernel), SELL and SELL-P; and the sort family: the merge-path u32 sort and
its key-value form (argsort), the radix module, the histogram and the
exclusive scans.

Entry points run on the card: builders build on the host and move their
containers to ``device`` (default ``"cuda"``), and a numpy input to an op
goes to ``device``; a torch tensor stays on its own device, so a CPU
tensor or ``device="cpu"`` asks for the CPU.

- ``libhpc_tpu_torch.sparse`` — ``CSR``, ``ELL``, ``DIA``, ``SBELL`` (with
  its ``FarPane`` and ``FarBlocks`` far sets) and ``auto_format``.
- ``libhpc_tpu_torch.ops``    — ``spmv`` (``csr_spmv``, ``ell_spmv``,
  ``far_spmv``, ``dia_spmv``, ``dia_spmv_t``), the kernel wrappers
  ``spmv_sbell``, ``far_sbell``, ``spmv_dia`` (``DiaPallas``),
  ``spmv_sell`` (``SELL``, ``SELLSplit``) and ``sellp`` (``SELLP``),
  ``solver``, ``sort_merge`` (``merge_sort_u32``), ``sort_merge_kv``
  (``merge_sort_kv_u32``, ``merge_argsort_u32``), ``sort`` (``sort_u32``,
  ``argsort_u32``, ``radix_sort_pipeline``, ``bitonic_sort``),
  ``histogram`` (``histogram_pallas``) and ``scan`` (``exclusive_scan``,
  ``inclusive_scan``, ``exclusive_scan_pallas``).
- ``libhpc_tpu_torch.bench``  — the deterministic matrix generators.
"""

__version__ = "0.1.0"

from libhpc_tpu_torch.sparse.csr import CSR  # noqa: F401
from libhpc_tpu_torch.sparse.sbell import SBELL  # noqa: F401
from libhpc_tpu_torch.ops import scan, sort_merge_kv  # noqa: F401
