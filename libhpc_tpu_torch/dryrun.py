"""Entry points of the flagship path: the CG step, and the multichip dry
run of every distributed path of the port, once, on tiny shapes.

``entry(device="cuda")`` is the port of ``__graft_entry__.py:entry``: it
returns ``(cg_step, (csr, x, b))``, one CG-style iteration (two CSR
matvecs, two dots, an axpy) and its operands on the 4096-row Poisson 64^2
system.

``dryrun_multichip`` is the port of ``__graft_entry__.py:
dryrun_multichip``. It takes the reference's
steps over an n-rank mesh: a distributed CG step (the overlapped DistCSR
matvec and two dots summed over the mesh), the DistCSR SpMM, the
halo-exchange DIA matvec, the 2-D SUMMA matvec (n >= 4, even), the
DistSBELL matvec (the SBELL kernel on every rank on the card), an AMG-PCG
solve on it and the overlapped halo box blur, checking each result's
shape and that it is finite.

    python -m libhpc_tpu_torch.dryrun [n_devices] [cuda|cpu]

``device="cuda"`` wants n cards and raises with fewer: under torchrun (or
any process group of n ranks) it runs in the group, else it starts n ranks
itself, one a card. ``device="cpu"`` starts n gloo ranks on this host.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist


def entry(device="cuda"):
    """(cg_step, (csr, x, b)) on Poisson 64^2: cg_step(csr, x, b) is
    r = b - A x, alpha = <r, r> / max(<r, A r>, 1e-30), x + alpha r."""
    from libhpc_tpu_torch.bench import matrices
    from libhpc_tpu_torch.ops import spmv
    from libhpc_tpu_torch.sparse import CSR

    A = matrices.poisson2d(64)
    csr = CSR.from_scipy(A, device=device)
    x = torch.from_numpy(np.linspace(-1, 1, A.shape[0], dtype=np.float32)
                         ).to(device)
    b = torch.ones((A.shape[0],), dtype=torch.float32, device=device)

    def cg_step(csr, x, b):
        r = b - spmv.csr_spmv(csr, x)
        Ar = spmv.csr_spmv(csr, r)
        alpha = torch.sum(r * r) / torch.clamp(torch.sum(r * Ar), min=1e-30)
        return x + alpha * r

    return cg_step, (csr, x, b)


def _check(t: torch.Tensor, shape: tuple, what: str) -> None:
    if tuple(t.shape) != tuple(shape) or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"dryrun {what}: shape {tuple(t.shape)} "
                             f"(expected {shape}), finite "
                             f"{bool(torch.isfinite(t).all())}")


def dryrun_rank(n_devices: int, device_type: str = "cuda") -> dict:
    """The dry run's steps in this rank of an n-rank process group;
    returns what it checked."""
    import scipy.sparse as sps

    from libhpc_tpu_torch.bench import matrices
    from libhpc_tpu_torch.parallel.collectives import all_reduce_sum
    from libhpc_tpu_torch.parallel.dist_amg import dist_amg_pcg
    from libhpc_tpu_torch.parallel.dist_dia import DistDIA, dist_dia_spmv_fn
    from libhpc_tpu_torch.parallel.dist_sbell import (DistSBELL,
                                                      dist_sbell_spmv_fn)
    from libhpc_tpu_torch.parallel.dist_spmv import (DistCSR, dist_spmm_fn,
                                                     dist_spmv_fn)
    from libhpc_tpu_torch.parallel.dist_stencil import dist_blur2d_fn
    from libhpc_tpu_torch.parallel.mesh import (make_mesh_1d, make_mesh_2d,
                                                mesh_device)

    mesh = make_mesh_1d(n_devices, device_type=device_type)
    dev = mesh_device(mesh)
    out = {"ranks": n_devices, "device_type": device_type}

    # distributed CG step over the row-partitioned Poisson system; grid >=
    # n_devices so rows a shard >= the bandwidth (DistDIA's guard)
    A = matrices.poisson2d(max(16, n_devices))
    dA = DistCSR.from_scipy(A, n_devices).shard(mesh)
    rl = dA.rows_local
    x = torch.ones(rl, device=dev)
    b = torch.full((rl,), 2.0, device=dev)
    matvec = dist_spmv_fn(dA, mesh)
    r = b - matvec(x)
    Ar = matvec(r)
    rr = all_reduce_sum(torch.sum(r * r), "x", mesh=mesh)
    rAr = all_reduce_sum(torch.sum(r * Ar), "x", mesh=mesh)
    step = x + rr / torch.clamp(rAr, min=1e-30) * r
    _check(step, (rl,), "dist CG step")

    Y = dist_spmm_fn(dA, mesh, n_cols=8)(torch.ones((rl, 8), device=dev))
    _check(Y, (rl, 8), "dist SpMM")

    dD = DistDIA.from_scipy(A, n_devices).shard(mesh)
    _check(dist_dia_spmv_fn(dD, mesh)(x), (dD.rows_local,), "dist DIA")

    if n_devices >= 4 and n_devices % 2 == 0:
        from libhpc_tpu_torch.parallel.dist2d import (Dist2DCSR,
                                                      dist2d_spmv_fn)

        grid = (2, n_devices // 2)
        mesh2 = make_mesh_2d(*grid, ("py", "px"), device_type=device_type)
        d2 = Dist2DCSR.from_scipy(A, grid).shard(mesh2)
        y2 = dist2d_spmv_fn(d2, mesh2, realign=False)(
            torch.ones(d2.cols_local, device=dev))
        _check(y2, (d2.rows_local,), "2-D SpMV")
        out["grid_2d"] = grid

    Au = matrices.block_random(40 * n_devices, block=8, blocks_per_row=4,
                               seed=7, half_band=3)
    dS = DistSBELL.from_scipy(Au, n_devices).shard(mesh)
    ys = dist_sbell_spmv_fn(dS, mesh)(torch.ones(dS.rows_local, device=dev))
    _check(ys, (dS.rows_local,), "DistSBELL SpMV")

    As = Au + Au.T
    rowsum = np.asarray(np.abs(As).sum(axis=1)).ravel()
    As = (As + sps.diags(rowsum + 1.0)).tocsr()
    xa, it, _ = dist_amg_pcg(As, mesh, n_devices,
                             np.ones(As.shape[0], np.float32), tol=1e-5,
                             max_iter=50)
    _check(xa, (dS.rows_local,), "dist AMG-PCG")
    if it >= 50:
        raise AssertionError(f"dryrun dist AMG-PCG: {it} iterations")
    out["amg_iterations"] = it

    m, n = 8 * n_devices * 2, 128
    v = dist_blur2d_fn(mesh, radius=2, overlap=True)(
        torch.ones((m // n_devices, n), device=dev))
    _check(v, (m // n_devices, n), "dist blur")
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list:
    """Run dryrun_rank on n ranks (see the module docstring); returns each
    rank's record."""
    from libhpc_tpu_torch.parallel.mesh import ensure_group, launch

    if device == "cpu":
        return launch(n_devices, dryrun_rank, (n_devices, "cpu"),
                      device_type="cpu")
    if device != "cuda":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) on 'cuda' needs "
                           f"{n_devices} NVIDIA GPUs; {have} found")
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"process group of {dist.get_world_size()} "
                             f"ranks for a dry run of {n_devices}")
        return [dryrun_rank(n_devices, "cuda")]
    if n_devices > 1:
        return launch(n_devices, dryrun_rank, (n_devices, "cuda"),
                      device_type="cuda")
    ensure_group("cuda")
    try:
        return [dryrun_rank(1, "cuda")]
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 1,
                           sys.argv[2] if len(sys.argv) > 2 else "cuda"))
