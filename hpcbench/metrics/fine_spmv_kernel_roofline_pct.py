"""fine_spmv_kernel_roofline_pct (%): the SpMV kernel alone on the finest
level's operator, where a V-cycle also launches it on the coarse levels:
the call's least time (roofline.py, from the fine operator's nnz and
shape) over the device time of the operations launched inside the
program's ``libhpc.spmv.launch`` spans that lie inside the benchmark's
matvec spans (the solver's own matvecs), a span. None where some launch
is unmatched or the program opens no such span."""

import bisect

from hpcbench import program_spans, roofline
from hpcbench.drive import SPAN_MATVEC


def _within(spans, t) -> bool:
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def read(rec):
    t = rec.trace
    if t is None or not getattr(rec.inputs, "nnz", None):
        return None
    m, n = rec.inputs.shape
    least = roofline.spmv_least_seconds(rec.inputs.nnz, m, n,
                                        rec.device_kind)
    matvecs = program_spans.spans(t, SPAN_MATVEC)
    calls = sum(_within(matvecs, s) for s, _ in
                program_spans.spans(t, program_spans.LAUNCH))
    ops = program_spans.ops_launched_in(t, program_spans.LAUNCH)
    if least is None or calls == 0 or not ops:
        return None
    fine = [op for op in ops if _within(matvecs, op[3])]
    if not fine:
        return None
    return 100.0 * least / (t.busy_s(fine) / calls)
