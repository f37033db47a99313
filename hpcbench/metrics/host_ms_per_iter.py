"""host_ms_per_iter (ms): the host's time inside the solver's iteration
bodies (the program's ``libhpc.solver.iteration`` spans: the enqueue of
an iteration, its sync left out), over the iterations the traced window
ran."""

from hpcbench import program_spans


def read(rec):
    return program_spans.host_ms_per_iter(rec)
