"""mg_ms_per_vcycle (ms): the device time of the operations launched inside
the program's ``libhpc.mg.vcycle`` spans (one a V-cycle: its smoother, its
residuals and transfers on every level), over the number of those spans in
the traced window."""

from hpcbench import program_spans

VCYCLE = "libhpc.mg.vcycle"


def read(rec):
    t = rec.trace
    if t is None:
        return None
    n = len(program_spans.spans(t, VCYCLE))
    ops = program_spans.ops_launched_in(t, VCYCLE)
    if n == 0 or not ops:
        return None
    return t.busy_s(ops) / n * 1e3
