"""vector_ms_per_iter (ms): device time launched inside the solve spans and
outside the matvec spans (dots, vector updates, scalars), over the
iterations the traced window ran."""

from hpcbench import layers


def read(rec):
    return layers.vector_ms_per_iter(rec)
