"""spmv_gflops (GFLOP/s): 2 x the matrix's true nonzeros x the matvecs
completed, over the whole window, which ends in a synchronize."""

from hpcbench import layers


def read(rec):
    return layers.spmv_gflops(rec)
