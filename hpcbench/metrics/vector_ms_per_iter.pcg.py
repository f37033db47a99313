"""vector_ms_per_iter.pcg (ms): the preconditioned solver's own vector work
an iteration (its dots, quotients and vector updates): the device time of
the operations launched inside the program's ``libhpc.solver.iteration``
spans and outside both the benchmark's matvec spans and the program's
``libhpc.mg.vcycle`` spans (the preconditioner), over the iterations the
traced window ran. The work before the loop (the first residual, z0 and
its dots) lies outside the iteration spans and is not counted."""

from hpcbench import program_spans
from hpcbench.drive import SPAN_MATVEC

VCYCLE = "libhpc.mg.vcycle"


def read(rec):
    t = rec.trace
    if t is None or rec.window.iterations == 0:
        return None
    ops = program_spans.ops_launched_in(t, program_spans.ITERATION)
    if not ops or not program_spans.spans(t, VCYCLE):
        return None
    other = set(program_spans.ops_launched_in(t, SPAN_MATVEC))
    other.update(program_spans.ops_launched_in(t, VCYCLE))
    own = [op for op in ops if op not in other]
    if not own:
        return None
    return t.busy_s(own) / rec.window.iterations * 1e3
