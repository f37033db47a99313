"""Distributed SpMV three ways: 1-D rows + all_gather, halo-exchange DIA,
2-D SUMMA.

Run: python -m libhpc_tpu_torch.examples.distributed_spmv [n_ranks] \
         [cuda|cpu]

Under torchrun (``torchrun --nproc-per-node=N -m ...``) it runs in
torchrun's ranks, one a card; otherwise it starts n_ranks ranks itself:
one a card, or gloo ranks on the CPU.
"""

import sys

import numpy as np


def main(device_type: str = "cuda") -> dict:
    """The three products of Poisson 64^2 in this rank of the process
    group, each joined over the ranks and checked against scipy; rank 0
    prints. Returns {way: max |y - A x|}."""
    import torch.distributed as dist

    from libhpc_tpu_torch.bench.matrices import poisson2d
    from libhpc_tpu_torch.parallel import programs
    from libhpc_tpu_torch.parallel.mesh import ensure_group

    ensure_group(device_type)
    nd = dist.get_world_size()
    A = poisson2d(64)                       # 4096 rows
    x = np.random.default_rng(0).random(A.shape[0]).astype(np.float32)
    y_ref = A @ x

    def joined(part):
        parts = [None] * nd
        dist.all_gather_object(parts, part)
        return np.concatenate(parts)

    err = {}
    y1 = joined(programs.csr_spmv(A, x, device_type=device_type))
    err["1D CSR + all_gather"] = float(np.abs(y1 - y_ref).max())
    y2 = joined(programs.dia_spmv(A, x, device_type=device_type))
    err["halo-exchange DIA"] = float(np.abs(y2 - y_ref).max())
    grid = (2, nd // 2) if nd % 2 == 0 else (1, nd)
    part = programs.dist2d_spmv(A, x, grid, realign=False,
                                device_type=device_type)
    # realign=False: rank (i, j) holds the py block i of y
    y3 = joined(part).reshape(grid[0], grid[1], -1)[:, 0].reshape(-1)
    err[f"2D SUMMA {grid}"] = float(np.abs(y3 - y_ref).max())
    if dist.get_rank() == 0:
        for way, e in err.items():
            print(f"{way + ':':<24}{e < 1e-3} (max |diff| {e:.2e})")
    return err


if __name__ == "__main__":
    import torch

    from libhpc_tpu_torch.parallel.mesh import run_in_group

    dt = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    n = int(sys.argv[1]) if len(sys.argv) > 1 else (
        torch.cuda.device_count() if dt == "cuda" else 8)
    run_in_group(n, main, (dt,), device_type=dt)
