"""Runnable examples of the port, mirroring the repository's examples/ on
the port's API. Each runs on the card by default:

    python -m libhpc_tpu_torch.examples.amg_solve [n_block_rows] [device]
        [n_ranks]
    python -m libhpc_tpu_torch.examples.distributed_spmv [n_ranks] [device]
    python -m libhpc_tpu_torch.examples.poisson_cg [grid_n] [device]
    python -m libhpc_tpu_torch.examples.multigrid_demo [k] [device]
"""
