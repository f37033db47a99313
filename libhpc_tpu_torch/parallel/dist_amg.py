"""Distributed AMG-preconditioned CG over the mesh.

Port of ``libhpc_tpu/parallel/dist_amg.py``: two-level aggregation AMG
whose fine level is the row-partitioned DistSBELL matvec (the all_gather
overlapped with the diagonal block; on the card two launches of
``csrc/sbell_spmv.cu`` a matvec) and whose coarse level is a dense inverse
(float64 ``np.linalg.inv`` cast to float32), replicated on every rank.

Between them, on each rank's shard: Jacobi sweeps are elementwise;
restriction sums r over global aggregate ids, a local ``index_add_`` then
an all_reduce (the reference's segment_sum over the sharded array);
prolongation gathers from the replicated coarse solution. The V-cycle is
SPD (symmetric pre/post smoothing), so it is the preconditioner operator
of the solver's PCG loop, run with dots summed over the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from libhpc_tpu_torch.ops.multigrid_sbell import _aggregate
from libhpc_tpu_torch.parallel.collectives import all_reduce_sum
from libhpc_tpu_torch.parallel.dist_sbell import DistSBELL, dist_sbell_spmv_fn
from libhpc_tpu_torch.parallel.mesh import mesh_device


def dist_amg_build(A, mesh, n_shards: int, axis: str = "x",
                   theta: float = 0.25, omega: float = 0.65,
                   pre: int = 2, post: int = 2,
                   coarse_hard_max: int = 8000):
    """Host setup, the same on every rank. Returns (vcycle, matvec,
    b_shard): vcycle the SPD preconditioner operator and matvec the fine
    operator, both on this rank's padded shard, and b_shard the function
    that pads a host rhs and returns this rank's shard on its device."""
    if pre < 1 or post < 1:
        raise ValueError(f"dist_amg_build: pre/post sweeps must be >= 1 "
                         f"(got pre={pre}, post={post})")
    if pre != post:
        raise ValueError(
            f"dist_amg_build: pre ({pre}) != post ({post}) makes the "
            "V-cycle non-symmetric — not a valid CG preconditioner")
    import scipy.sparse as sps

    A = sps.csr_matrix(A).astype(np.float32)
    n = A.shape[0]
    dA = DistSBELL.from_scipy(A, n_shards).shard(mesh, axis)
    matvec = dist_sbell_spmv_fn(dA, mesh, axis)
    n_pad = dA.shape[0]
    rl = dA.rows_local

    agg, nc = _aggregate(A, theta)
    if nc > coarse_hard_max:
        raise ValueError(
            f"dist_amg_build: coarse level has {nc} rows "
            f"(> {coarse_hard_max}); aggregation failed to coarsen")
    P_t = sps.csr_matrix(
        (np.ones(n, np.float32), (np.arange(n), agg)), shape=(n, nc))
    Ac = (P_t.T @ A @ P_t).tocsr()
    dev = mesh_device(mesh)
    coarse_inv = torch.from_numpy(np.linalg.inv(
        Ac.toarray().astype(np.float64)).astype(np.float32)).to(dev)

    diag = np.zeros(n_pad, np.float32)
    diag[:n] = A.diagonal()
    dinv_np = np.zeros(n_pad, np.float32)
    nz = diag != 0.0
    dinv_np[nz] = omega / diag[nz]
    aggp_np = np.full(n_pad, nc, np.int64)     # padding rows -> dummy agg
    aggp_np[:n] = agg

    i = mesh.get_local_rank(axis)
    mine = slice(i * rl, (i + 1) * rl)
    dinv = torch.from_numpy(dinv_np[mine].copy()).to(dev)
    aggp = torch.from_numpy(aggp_np[mine].copy()).to(dev)

    def vcycle(f):
        u = dinv * f
        for _ in range(pre - 1):
            u = u + dinv * (f - matvec(u))
        r = f - matvec(u)
        rc = all_reduce_sum(r.new_zeros(nc + 1).index_add_(0, aggp, r),
                            axis, mesh=mesh)[:nc]
        ec = coarse_inv @ rc
        u = u + torch.cat([ec, ec.new_zeros(1)])[aggp]
        for _ in range(post):
            u = u + dinv * (f - matvec(u))
        return u

    def b_shard(b_host):
        b = np.zeros(n_pad, np.float32)
        b[:n] = np.asarray(b_host, np.float32)
        return torch.from_numpy(b[mine].copy()).to(dev)

    return vcycle, matvec, b_shard


def dist_amg_pcg(A, mesh, n_shards: int, b, tol: float = 1e-6,
                 max_iter: int = 200, **kw):
    """One-call distributed AMG-PCG solve of A x = b (b a host vector).
    Returns (x_local, iters, res2): this rank's shard of the padded
    solution, and iters and res2 equal on every rank."""
    from libhpc_tpu_torch.ops.solver import _pcg_op
    from libhpc_tpu_torch.parallel.dist_spmv import global_dot

    vcycle, matvec, b_shard = dist_amg_build(A, mesh, n_shards, **kw)
    return _pcg_op(matvec, vcycle, b_shard(b), None, tol, max_iter,
                   global_dot(kw.get("axis", "x"), mesh))
