"""Tracing and profiling helpers (SURVEY.md §5.1).

Port of ``libhpc_tpu/utils/profiling.py``. libHPC brackets every pipeline
stage with NVTX ranges (cuda_radix_sort_v4.cu:99-211) for Nsight
timelines; the reference re-exports ``jax.named_scope`` and wraps
``jax.profiler`` traces. The port:

  - ``annotate(name)``: a ``torch.profiler.record_function`` range while
    a profiler records, and otherwise one shared no-op context, for the
    cost of one read of torch's profiler flag. The port opens such ranges
    at its layer boundaries (``libhpc.*``: the Krylov loops of
    ``ops/solver.py``, the SpMV wrappers of ``ops/spmv_dia.py`` and
    ``ops/spmv_sbell.py``, the V-cycle and smoother of
    ``ops/multigrid_dia.py``), so they cost nothing measurable on the hot
    path when nobody traces. A range lands in the profiler's Chrome trace
    beside the device operations, on the same clock. For Nsight, run
    under ``torch.autograd.profiler.emit_nvtx()``: it sets the same flag
    and makes every range an NVTX range;
  - ``trace_to(logdir)``: a ``torch.profiler`` trace of CPU and CUDA
    activity written into ``logdir`` (TensorBoard's trace format).
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

# The port's own ranges. Their names are fixed: readers of its traces
# match them, whatever the format or solver underneath.
SOLVER_SYNC = "libhpc.solver.sync"            # a Krylov loop's host test
SOLVER_ITERATION = "libhpc.solver.iteration"  # one iteration's body
SPMV_PREPARE = "libhpc.spmv.prepare"          # x laid out for the kernel
SPMV_LAUNCH = "libhpc.spmv.launch"            # operand checks and launch
MG_VCYCLE = "libhpc.mg.vcycle"                # one whole V-cycle, top level
MG_SMOOTH = "libhpc.mg.smooth"                # one SymGS of one level

_OFF = contextlib.nullcontext()


def annotate(name: str):
    """Name a region: a torch.profiler range while a profiler (or
    ``emit_nvtx`` / ``emit_itt``) records, else a no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a profiler trace of the block into `logdir` (one
    ``*.pt.trace.json`` file; viewable in TensorBoard or Perfetto)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
