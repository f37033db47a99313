"""Readers of the program's own spans in a traced run.

The port opens ``record_function`` ranges named ``libhpc.*`` at its layer
boundaries while a profiler records: ``libhpc.solver.sync`` around a
Krylov loop's host test, ``libhpc.solver.iteration`` around an
iteration's body, ``libhpc.spmv.prepare`` around the glue that lays x out
for an SpMV kernel and ``libhpc.spmv.launch`` around its operand checks
and launch. ``Trace.host`` holds them with every other host event of the
window's thread. A program that opens none of them (one older than them)
gives no number. Neither does a reader that puts device operations under a
span by their launch time in a trace where some operation has no launch:
it would take the launch time of the operation before it, and a kernel
would land under the wrong span.
"""

from __future__ import annotations

import bisect

from hpcbench import roofline, stats

SYNC = "libhpc.solver.sync"
ITERATION = "libhpc.solver.iteration"
LAUNCH = "libhpc.spmv.launch"


def spans(t, name: str) -> list:
    """Sorted (start, end) of the program's `name` spans inside the
    window."""
    return [(s, e) for s, e, n in t.host
            if n == name and s >= t.t0 and e <= t.t1]


def ops_launched_in(t, name: str):
    """Device operations launched inside a `name` span (one name's spans
    do not overlap), or None where some operation has no launch."""
    if t.unlaunched:
        return None
    sp = spans(t, name)
    starts = [s for s, _ in sp]
    out = []
    for op in t.device_ops:
        i = bisect.bisect_right(starts, op[3]) - 1
        if i >= 0 and op[3] <= sp[i][1]:
            out.append(op)
    return out


def sync_idle_ms_per_iter(rec):
    """The device's idle time that runs across the end of each
    convergence sync, from the end of the last operation before it to the
    start of the next, summed over the window's iterations."""
    t = rec.trace
    if t is None or not t.device_ops or rec.window.iterations == 0:
        return None
    ends = [e for _, e in spans(t, SYNC)]
    if not ends:
        return None
    gaps = stats.gaps([(s, e) for s, e, _, _ in t.device_ops], t.t0, t.t1)
    starts = [s for s, _ in gaps]
    hit = set()
    for e in ends:
        i = bisect.bisect_right(starts, e) - 1
        if i >= 0 and e <= gaps[i][1]:
            hit.add(i)
    idle_us = sum(gaps[i][1] - gaps[i][0] for i in hit)
    return idle_us * 1e-3 / rec.window.iterations


def host_ms_per_iter(rec):
    """The host's time inside the solver's iteration spans (from the
    first matvec through the last update, the sync left out), over the
    window's iterations."""
    t = rec.trace
    if t is None or rec.window.iterations == 0:
        return None
    sp = spans(t, ITERATION)
    if not sp:
        return None
    return sum(e - s for s, e in sp) * 1e-3 / rec.window.iterations


def spmv_kernel_roofline_pct(rec):
    """The SpMV kernel alone against the call's least time: the least
    time over the device time of the operations launched inside the
    program's launch spans, a span."""
    t = rec.trace
    if t is None or not getattr(rec.inputs, "nnz", None):
        return None
    m, n = rec.inputs.shape
    least = roofline.spmv_least_seconds(rec.inputs.nnz, m, n,
                                        rec.device_kind)
    calls = len(spans(t, LAUNCH))
    ops = ops_launched_in(t, LAUNCH)
    if least is None or calls == 0 or not ops:
        return None
    return 100.0 * least / (t.busy_s(ops) / calls)
