"""Tracing and profiling helpers (SURVEY.md §5.1).

Port of ``libhpc_tpu/utils/profiling.py``. libHPC brackets every pipeline
stage with NVTX ranges (cuda_radix_sort_v4.cu:99-211) for Nsight
timelines; the reference re-exports ``jax.named_scope`` and wraps
``jax.profiler`` traces. The port:

  - ``annotate(name)``: a context manager that opens
    ``torch.profiler.record_function(name)`` (a range in torch.profiler
    traces) and, when CUDA is available, an NVTX range of the same name
    (Nsight timelines, as libHPC's);
  - ``trace_to(logdir)``: a ``torch.profiler`` trace of CPU and CUDA
    activity written into ``logdir`` (TensorBoard's trace format);
  - ``wall_timer``: a scoped host-phase timer, as the reference's.

As in the reference, the library's own ops carry no ranges: callers put
them where they want them.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def annotate(name: str):
    """Name a region: a torch.profiler range and, with CUDA, an NVTX
    range."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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


@contextlib.contextmanager
def wall_timer(label: str, results: dict | None = None):
    """Host-phase timer; stores seconds into `results[label]` if given."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if results is not None:
            results[label] = dt
