"""spmv_roofline_pct.spmv (%): the matvec call of the stream cells, glue
included, against its least time (roofline.py), from the device trace."""

from hpcbench import layers


def read(rec):
    return layers.spmv_roofline_pct(rec)
