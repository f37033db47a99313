"""Aggregation AMG with the SBELL SpMV kernel as the smoother engine.

Port of ``libhpc_tpu/ops/multigrid_sbell.py``: multigrid for arbitrary SPD
operators on the main path. Every smoothing sweep of every level runs the
pane-layout SBELL product (``ops/spmv_sbell.py:sbell_spmv_panes``), so on
the card a level whose far set is a FarPane (or empty) makes one fused
launch of ``csrc/sbell_spmv.cu`` a sweep; a FarBlocks level makes a near
launch plus the plain ``far_spmv``.

  setup (host, once)  greedy strength-based aggregation, Galerkin coarse
      operators P^T A P in scipy, each level stored as SBELL plus an
      inverse-diagonal plane in guarded pane layout; the coarsest level is
      a dense inverse (float64 ``np.linalg.inv`` cast to float32). The
      builders are the reference's numpy code step for step, so every
      level equals the reference's array by array. The hierarchy moves to
      ``device`` (default ``"cuda"``) once at the end.
  apply               weighted-Jacobi sweeps in pane layout (the kernel's
      output layout is the next sweep's input layout); piecewise-constant
      transfers are one ``index_add_`` (restrict) and one gather (prolong)
      a level, smoothed aggregation uses ``csr_spmv`` with P and P^T; the
      coarsest solve is ``coarse_inv @ f`` (``torch.matmul``: the
      reference computes it outside any Pallas kernel).
  symmetric pre/post smoothing keeps the V-cycle SPD, so it serves as the
      preconditioner operator of ``solver.pcg_op``.

``index_add_`` adds with atomics on the card, so a V-cycle's last bits may
vary from run to run there; on the CPU the order is fixed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from libhpc_tpu_torch.ops._cuda_utils import as_tensor
from libhpc_tpu_torch.ops.spmv_sbell import (panes_to_x, sbell_spmv_panes,
                                             x_to_panes)
from libhpc_tpu_torch.sparse._leaves import TensorLeaves
from libhpc_tpu_torch.sparse.sbell import PANE_COLS, SBELL


@dataclasses.dataclass(frozen=True)
class AMGLevel(TensorLeaves):
    """One fine/intermediate level of the hierarchy."""

    sbell: SBELL              # the level operator on the kernel path
    dinv3: torch.Tensor       # omega / diag in GUARDED pane layout (0 pad)
    agg: torch.Tensor         # (n,) i32 aggregate id of each row
    p_csr: object             # smoothed-aggregation P as CSR, or None
    pt_csr: object            # P^T as CSR, or None
    n: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))

    to_numpy = TensorLeaves.tree_to_numpy


@dataclasses.dataclass(frozen=True)
class AMGHierarchy(TensorLeaves):
    levels: tuple             # tuple[AMGLevel, ...]
    coarse_inv: torch.Tensor  # (nc, nc) dense inverse of the coarsest op
    pre: int = dataclasses.field(metadata=dict(static=True))
    post: int = dataclasses.field(metadata=dict(static=True))

    to_numpy = TensorLeaves.tree_to_numpy


def _aggregate(A, theta: float):
    """Greedy strength-based aggregation (host). Returns (agg ids, nc).

    Strong edge (classical row-max strength): |a_ij| >= theta *
    max_{k != i} |a_ik|. Pass 1 seeds an aggregate from every node whose
    strong neighbourhood is untouched; pass 2 attaches leftovers to a
    neighbouring aggregate; pass 3 makes singletons of the rest."""
    import scipy.sparse as sps

    A = sps.csr_matrix(A)
    n = A.shape[0]
    coo = A.tocoo()
    off = coo.row != coo.col
    absd = np.where(off, np.abs(coo.data), 0.0)
    rowmax = np.zeros(n)
    np.maximum.at(rowmax, coo.row, absd)
    strong = absd >= theta * np.maximum(rowmax[coo.row], 1e-30)
    strong &= off
    S = sps.csr_matrix(
        (np.ones(int(strong.sum()), np.int8),
         (coo.row[strong], coo.col[strong])), shape=(n, n))
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, np.int64)
    nc = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = indices[indptr[i]:indptr[i + 1]]
        if (agg[nb] == -1).all():
            agg[i] = nc
            agg[nb] = nc
            nc += 1
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = indices[indptr[i]:indptr[i + 1]]
        owned = nb[agg[nb] != -1]
        if owned.size:
            agg[i] = agg[owned[0]]
    rest = np.flatnonzero(agg == -1)
    agg[rest] = nc + np.arange(rest.size)
    nc += rest.size
    return agg, nc


def _level_from_scipy(A_l, agg, nc, omega: float, P=None) -> AMGLevel:
    """One level on the host (CPU tensors)."""
    sb = SBELL.from_scipy(A_l, device="cpu")
    n = A_l.shape[0]
    npad = sb.n_panes * PANE_COLS
    diag = np.asarray(A_l.diagonal(), np.float32)
    dinv = np.zeros(npad, np.float32)
    nzd = diag != 0.0
    dinv[:n][nzd] = omega / diag[nzd]
    dinv3 = x_to_panes(sb, torch.from_numpy(dinv))
    p_csr = pt_csr = None
    if P is not None:
        from libhpc_tpu_torch.sparse.csr import CSR

        p_csr = CSR.from_scipy(P.tocsr(), device="cpu")
        pt_csr = CSR.from_scipy(P.T.tocsr(), device="cpu")
    return AMGLevel(sbell=sb, dinv3=dinv3,
                    agg=torch.from_numpy(agg.astype(np.int32)),
                    p_csr=p_csr, pt_csr=pt_csr, n=n, nc=nc)


def amg_setup(A, n_levels: int = 3, theta: float = 0.25,
              omega: float = 0.65, coarse_max: int = 3000,
              pre: int = 2, post: int = 2,
              coarse_hard_max: int = 8000,
              smooth_p: bool = False, device="cuda") -> AMGHierarchy:
    """Build the hierarchy from a scipy SPD matrix on the host, then move
    it to ``device`` once.

    Coarsening stops early once the operator is <= coarse_max rows; the
    coarsest operator is inverted densely. If aggregation stalls and the
    coarsest level exceeds coarse_hard_max, the setup raises instead of
    feeding a huge dense inverse to LAPACK.

    smooth_p=True builds SMOOTHED aggregation: the tentative piecewise-
    constant P is damped-Jacobi smoothed (P = (I - 2/3 D^-1 A) P_t), and
    the apply uses csr_spmv for P and P^T."""
    # _cycle's first sweep comes from the zero initial guess (pre-1 more
    # follow), so pre >= 1 is structural; and the V-cycle is SPD (a valid
    # CG preconditioner) only when pre == post
    if pre < 1 or post < 1:
        raise ValueError(f"amg_setup: pre/post sweeps must be >= 1 "
                         f"(got pre={pre}, post={post})")
    if pre != post:
        raise ValueError(
            f"amg_setup: pre ({pre}) != post ({post}) makes the V-cycle "
            "non-symmetric — not a valid CG preconditioner; use equal "
            "sweep counts")
    import scipy.sparse as sps

    A_l = sps.csr_matrix(A).astype(np.float32)
    if A_l.shape[0] != A_l.shape[1]:
        raise ValueError("amg_setup needs a square (SPD) operator")
    levels = []
    for _ in range(max(n_levels - 1, 0)):
        if A_l.shape[0] <= coarse_max:
            break
        agg, nc = _aggregate(A_l, theta)
        if nc > 0.8 * A_l.shape[0]:
            # coarsening stalled: stop rather than build a level that
            # shrinks nothing
            break
        n = A_l.shape[0]
        P = sps.csr_matrix(
            (np.ones(n, np.float32), (np.arange(n), agg)), shape=(n, nc))
        if smooth_p:
            dinv = 1.0 / np.maximum(np.abs(A_l.diagonal()), 1e-30)
            Dinv = sps.diags(dinv.astype(np.float32))
            P = (P - (2.0 / 3.0) * (Dinv @ (A_l @ P))).tocsr()
            P.sort_indices()
        levels.append(_level_from_scipy(A_l, agg, nc, omega,
                                        P=P if smooth_p else None))
        A_l = (P.T @ A_l @ P).tocsr()
        A_l.sort_indices()
    if A_l.shape[0] > coarse_hard_max:
        raise ValueError(
            f"amg_setup: coarsest level has {A_l.shape[0]} rows "
            f"(> {coarse_hard_max}) — aggregation failed to coarsen this "
            "operator (check the strength threshold theta, or give more "
            "n_levels)")
    coarse_inv = torch.from_numpy(
        np.linalg.inv(A_l.toarray().astype(np.float64)).astype(np.float32))
    return AMGHierarchy(levels=tuple(levels), coarse_inv=coarse_inv,
                        pre=pre, post=post).to(device)


def _smooth(lev: AMGLevel, u3, f3, sweeps: int):
    """Weighted-Jacobi sweeps in guarded pane layout (the guard panes of
    dinv3 are zero, so guards stay zero for the chained kernel input).
    Each sweep makes a new contiguous u3, as the kernel requires."""
    for _ in range(sweeps):
        u3 = u3 + lev.dinv3 * (f3 - sbell_spmv_panes(lev.sbell, u3))
    return u3


def _cycle(H: AMGHierarchy, li: int, f):
    """Recursive V-cycle body (flat f per level)."""
    if li == len(H.levels):
        return H.coarse_inv @ f
    lev = H.levels[li]
    sb = lev.sbell
    npad = sb.n_panes * PANE_COLS
    f3 = x_to_panes(sb, F.pad(f, (0, npad - lev.n)))
    u3 = lev.dinv3 * f3                      # first sweep from zero guess
    u3 = _smooth(lev, u3, f3, H.pre - 1)
    r3 = f3 - sbell_spmv_panes(sb, u3)
    r = panes_to_x(sb, r3)[:lev.n]
    if lev.p_csr is None:     # piecewise-constant transfers
        rc = r.new_zeros(lev.nc).index_add_(0, lev.agg, r)
    else:                     # smoothed aggregation: P^T r
        from libhpc_tpu_torch.ops.spmv import csr_spmv

        rc = csr_spmv(lev.pt_csr, r)
    ec = _cycle(H, li + 1, rc)
    if lev.p_csr is None:
        e = ec[lev.agg]
    else:
        from libhpc_tpu_torch.ops.spmv import csr_spmv

        e = csr_spmv(lev.p_csr, ec)
    u3 = u3 + x_to_panes(sb, F.pad(e, (0, npad - lev.n)))
    u3 = _smooth(lev, u3, f3, H.post)
    return panes_to_x(sb, u3)[:lev.n]


def amg_vcycle(H: AMGHierarchy, b):
    """One V-cycle from a zero initial guess: the SPD preconditioner
    operator. A numpy b goes to the hierarchy's device."""
    return _cycle(H, 0, as_tensor(b, H.device))


def amg_pcg(H: AMGHierarchy, matvec, b, tol: float = 1e-6,
            max_iter: int = 200):
    """AMG-preconditioned CG on the fine operator.

    matvec: the FINE-level operator (typically
    ``lambda v: sbell_spmv(H.levels[0].sbell, v)``); returns (x, iters,
    res2) from ops/solver.py:pcg_op (one host sync an iteration)."""
    from libhpc_tpu_torch.ops.solver import pcg_op

    return pcg_op(matvec, lambda r: amg_vcycle(H, r),
                  as_tensor(b, H.device), tol=tol, max_iter=max_iter)
