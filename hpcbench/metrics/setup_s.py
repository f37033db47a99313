"""setup_s (s): process start to the window: imports, the card, the
inputs from the seed, the container build, the warm-up (and, in the first
run of a checkout, the kernels' build)."""


def read(rec):
    return rec.setup_s
