"""requests_per_s (req/s): requests completed over the whole window, on
the host clock; a request ends in a synchronize."""

from hpcbench import layers


def read(rec):
    return layers.request_rate(rec)
