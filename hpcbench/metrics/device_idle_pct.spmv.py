"""device_idle_pct.spmv (%): 1 - the union of device operations over the
traced window of a stream cell."""

from hpcbench import layers


def read(rec):
    return layers.device_idle_pct(rec)
