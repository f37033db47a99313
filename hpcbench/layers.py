"""Reductions the metric readers share (metrics/<name>.py).

A reader gets the run's ``Record`` and returns a number, or None where the
run has nothing for it to read (no trace, no such span, a card whose peaks
roofline.py does not list).
"""

from __future__ import annotations

import dataclasses

from hpcbench import roofline, stats
from hpcbench.drive import SPAN_MATVEC, SPAN_REQUEST


@dataclasses.dataclass
class Record:
    """What a run measured, as the metric readers see it."""

    cell: object          # spec.Cell
    inputs: object        # drive.Inputs
    window: object        # drive.Window (the traced window in a traced run)
    setup_s: float
    build_s: float
    device_kind: str
    trace: object = None  # trace.Trace in a traced run


def request_rate(rec: Record):
    """Requests of any kind completed over the window."""
    if rec.window.attempted == 0:
        return None
    return stats.rate(rec.window.attempted, rec.window.seconds)


def request_ms_percentile(rec: Record, q: float):
    """Over every request whose latency the kind recorded."""
    if not rec.window.latencies_s:
        return None
    return stats.percentile(rec.window.latencies_s, q) * 1e3


def spmv_gflops(rec: Record):
    if rec.window.matvecs == 0 or not getattr(rec.inputs, "nnz", None):
        return None
    flops = roofline.spmv_flops(rec.inputs.nnz) * rec.window.matvecs
    return flops / rec.window.seconds / 1e9


def spmv_roofline_pct(rec: Record):
    """The whole matvec call, glue included, against its least time: the
    least time over the device time of the operations launched inside
    the benchmark's matvec spans, a call."""
    t = rec.trace
    if t is None or not getattr(rec.inputs, "nnz", None):
        return None
    m, n = rec.inputs.shape
    least = roofline.spmv_least_seconds(rec.inputs.nnz, m, n,
                                        rec.device_kind)
    calls = t.span_count(SPAN_MATVEC)
    ops = t.ops_launched_in(SPAN_MATVEC)
    if least is None or calls == 0 or not ops:
        return None
    return 100.0 * least / (t.busy_s(ops) / calls)


def vector_ms_per_iter(rec: Record):
    """Device time of the solver loop outside its matvecs (dots, vector
    updates, scalars), an iteration."""
    t = rec.trace
    if t is None or rec.window.iterations == 0:
        return None
    ops = t.ops_launched_in(SPAN_REQUEST, outside=SPAN_MATVEC)
    if not ops:
        return None
    return t.busy_s(ops) / rec.window.iterations * 1e3


def device_idle_pct(rec: Record):
    t = rec.trace
    if t is None or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
