"""hpcbench: the benchmark of libhpc_tpu_torch, the PyTorch and CUDA port.

Run one cell with ``python hpcbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; README.md says
how the harness finds a cell's files by name.
"""
