"""sync_idle_ms_per_iter (ms): the device's idle time running across the
end of each of the solver's convergence syncs (the program's
``libhpc.solver.sync`` spans), over the iterations the traced window
ran."""

from hpcbench import program_spans


def read(rec):
    return program_spans.sync_idle_ms_per_iter(rec)
