"""spmv_kernel_roofline_pct.spmv (%): the SpMV kernel alone in the stream
cells (the device operations launched inside the program's
``libhpc.spmv.launch`` spans, a span) against the call's least time
(roofline.py), from the device trace."""

from hpcbench import program_spans


def read(rec):
    return program_spans.spmv_kernel_roofline_pct(rec)
