"""request_ms_p95 (ms): the 95th percentile of the latency of every request
of the window, on the host clock, each ending in a synchronize."""

from hpcbench import layers


def read(rec):
    return layers.request_ms_percentile(rec, 95)
