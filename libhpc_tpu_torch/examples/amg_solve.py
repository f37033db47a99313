"""AMG-preconditioned CG on an unstructured SPD operator, on one device
and distributed.

Run: python -m libhpc_tpu_torch.examples.amg_solve [n_block_rows] [device]
         [n_ranks]

The operator is an SPD-ified FEM-like block matrix. The hierarchy is built
on the host (``amg_setup``) and applied on the device; every smoothing
sweep runs the SBELL SpMV kernel. The distributed half solves it again with
``parallel.dist_amg.dist_amg_pcg`` over n_ranks ranks (default: 8 gloo
ranks on the CPU, or one rank a card), started here.
"""

import sys
import time

import numpy as np
import scipy.sparse as sps
import torch


def spd_fem(n_block_rows: int):
    from libhpc_tpu_torch.bench.matrices import block_random

    B = block_random(n_block_rows, block=8, blocks_per_row=6, seed=11,
                     half_band=5, far_fraction=0.02)
    A = (B + B.T).tocsr()
    rowsum = np.asarray(np.abs(A).sum(axis=1)).ravel()
    return (A + sps.diags(rowsum + 1.0)).tocsr().astype(np.float32)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dist_solve(A, b, device_type: str = "cuda"):
    """The distributed half, in each rank of the process group: AMG-PCG
    over a DistSBELL fine level; returns (x joined, iterations)."""
    import torch.distributed as dist

    from libhpc_tpu_torch.parallel import programs

    x, it, _ = programs.amg_pcg(A, b, tol=1e-6, device_type=device_type)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, x)
    return np.concatenate(parts)[:A.shape[0]], it


def main(n_block_rows: int = 800, device="cuda", n_ranks=None) -> dict:
    from libhpc_tpu_torch.ops import multigrid_sbell as amg
    from libhpc_tpu_torch.ops import solver
    from libhpc_tpu_torch.ops.spmv_sbell import sbell_spmv
    from libhpc_tpu_torch.sparse.sbell import SBELL

    A = spd_fem(n_block_rows)
    print(f"operator: {A.shape[0]} rows, {A.nnz / 1e6:.2f}M nnz")
    rng = np.random.default_rng(0)
    b_np = rng.standard_normal(A.shape[0]).astype(np.float32)

    t0 = time.perf_counter()
    H = amg.amg_setup(A, n_levels=3, device=device)
    print(f"AMG setup: {time.perf_counter() - t0:.1f}s, "
          f"{len(H.levels) + 1} levels")
    if H.levels:
        sb = H.levels[0].sbell
    else:   # tiny operator: coarse-only hierarchy (direct solve)
        sb = SBELL.from_scipy(A, device=device)
    b = torch.from_numpy(b_np).to(device)

    t0 = time.perf_counter()
    x, it, _ = amg.amg_pcg(H, lambda v: sbell_spmv(sb, v), b, tol=1e-6)
    _sync(device)
    dt = time.perf_counter() - t0
    r = b_np - A @ x.cpu().numpy()
    rel = float(np.linalg.norm(r) / np.linalg.norm(b_np))
    print(f"AMG-PCG: {it} iterations, rel res {rel:.2e}, {dt:.3f}s")

    _, it_cg, _ = solver.cg(lambda v: sbell_spmv(sb, v), b, tol=1e-6,
                            max_iter=1000)
    print(f"plain CG for comparison: {it_cg} iterations")

    # ---- distributed ------------------------------------------------------
    from libhpc_tpu_torch.parallel.mesh import launch

    dt = torch.device(device).type
    if n_ranks is None:
        n_ranks = 8 if dt == "cpu" else torch.cuda.device_count()
    xd, itd = launch(n_ranks, dist_solve, (A, b_np, dt), device_type=dt)[0]
    rd = b_np - A @ xd
    rel_d = float(np.linalg.norm(rd) / np.linalg.norm(b_np))
    print(f"distributed AMG-PCG ({n_ranks} shards): {itd} iterations, "
          f"rel res {rel_d:.2e}")
    return {"iterations": it, "cg_iterations": it_cg, "rel_res": rel,
            "dist_iterations": itd, "dist_rel_res": rel_d}


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 800,
         sys.argv[2] if len(sys.argv) > 2 else "cuda",
         int(sys.argv[3]) if len(sys.argv) > 3 else None)
