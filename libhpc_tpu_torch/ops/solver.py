"""Iterative-solver building blocks: axpy/dot/norm + CG, PCG, BiCGSTAB.

Port of ``libhpc_tpu/ops/solver.py``. Each ``lax.while_loop`` of the
reference becomes a Python loop that tests ``rs > tol2`` on the host once
per iteration: one device sync per iteration. Vectors may have any shape
(the SBELL pane layout included); dots reduce over every element.

While a profiler records, each loop's test is a ``libhpc.solver.sync``
range and each iteration's body a ``libhpc.solver.iteration`` range
(``utils/profiling.annotate``), so a trace splits the device's idle time
after the sync from the host's enqueue of the next iteration.

Works with any container that supports ``@`` or with any matvec callable.
All solvers return ``(x, n_iters, res2)`` like the reference: n_iters is a
Python int and res2 the final squared residual as a 0-d tensor.
"""

from __future__ import annotations

from typing import Callable

import torch

from libhpc_tpu_torch.utils.profiling import (SOLVER_ITERATION,
                                              SOLVER_SYNC, annotate)


def axpy(a, x, y):
    """a*x + y."""
    return a * x + y


def dot(x, y):
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def _sdot(x, y):
    return torch.sum(x * y)


def norm2(x):
    return torch.sqrt(dot(x, x))


def _tol2(b, tol: float, sdot=_sdot):
    """tol^2 * max(<b,b>, 1) in b's dtype, as the reference computes it."""
    one = torch.ones((), dtype=b.dtype, device=b.device)
    return torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 \
        * torch.maximum(sdot(b, b), one)


def cg(matvec: Callable, b, x0=None, tol: float = 1e-6, max_iter: int = 1000):
    """Conjugate gradient for SPD systems. Returns (x, n_iters, res2)."""
    return _cg(matvec, b, x0, tol, max_iter, _sdot)


def _cg(matvec, b, x0, tol, max_iter, sdot):
    """cg with the dot product `sdot`: the distributed solvers
    (parallel/) pass a dot summed over every shard, so that every rank
    takes the same number of iterations."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = r
    rs = sdot(r, r)
    tol2 = _tol2(b, tol, sdot)
    it = 0
    while it < max_iter:
        with annotate(SOLVER_SYNC):
            go = bool(rs > tol2)
        if not go:
            break
        with annotate(SOLVER_ITERATION):
            Ap = matvec(p)
            alpha = rs / sdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = sdot(r, r)
            p = r + (rs_new / rs) * p
            rs = rs_new
        it += 1
    return x, it, rs


def jacobi(matvec: Callable, diag, b, x0=None, n_iter: int = 100,
           omega: float = 1.0):
    """Weighted Jacobi smoother: x += omega * (b - A x) / diag."""
    x = torch.zeros_like(b) if x0 is None else x0
    inv_d = torch.tensor(omega, dtype=b.dtype, device=b.device) / diag
    for _ in range(n_iter):
        x = x + inv_d * (b - matvec(x))
    return x


def pcg(matvec: Callable, diag, b, x0=None, tol: float = 1e-6,
        max_iter: int = 1000):
    """Jacobi-preconditioned CG (M = diag(A)). Returns (x, iters, res2)."""
    inv_d = 1.0 / diag
    return pcg_op(matvec, lambda r: inv_d * r, b, x0, tol, max_iter)


def pcg_op(matvec: Callable, minv: Callable, b, x0=None, tol: float = 1e-6,
           max_iter: int = 1000):
    """CG with an arbitrary SPD preconditioner OPERATOR z = minv(r).
    Returns (x, iters, res2)."""
    return _pcg_op(matvec, minv, b, x0, tol, max_iter, _sdot)


def _pcg_op(matvec, minv, b, x0, tol, max_iter, sdot):
    """pcg_op with the dot product `sdot` (see _cg)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = minv(r)
    p = z
    rz = sdot(r, z)
    rr = sdot(r, r)
    tol2 = _tol2(b, tol, sdot)
    it = 0
    while it < max_iter:
        with annotate(SOLVER_SYNC):
            go = bool(rr > tol2)
        if not go:
            break
        with annotate(SOLVER_ITERATION):
            Ap = matvec(p)
            alpha = rz / sdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = minv(r)
            rz_new = sdot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            rr = sdot(r, r)
        it += 1
    return x, it, rr


def bicgstab(matvec: Callable, b, x0=None, tol: float = 1e-6,
             max_iter: int = 1000):
    """BiCGSTAB for general (nonsymmetric) systems. Returns (x, iters,
    res2); breakdown (rho ≈ 0) is guarded as in the reference."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    tol2 = _tol2(b, tol)
    eps = torch.tensor(1e-30, dtype=b.dtype, device=b.device)

    def safe(d):
        return torch.where(torch.abs(d) > eps, d, eps)

    one = torch.ones((), dtype=b.dtype, device=b.device)
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho, alpha, omega = one, one, one
    rr = _sdot(r, r)
    it = 0
    while it < max_iter:
        with annotate(SOLVER_SYNC):
            go = bool(rr > tol2)
        if not go:
            break
        with annotate(SOLVER_ITERATION):
            rho_new = _sdot(rhat, r)
            beta = (rho_new / safe(rho)) * (alpha / safe(omega))
            p = r + beta * (p - omega * v)
            v = matvec(p)
            alpha = rho_new / safe(_sdot(rhat, v))
            s_vec = r - alpha * v
            t = matvec(s_vec)
            tt = _sdot(t, t)
            omega = _sdot(t, s_vec) / torch.where(tt > eps, tt, eps)
            x = x + alpha * p + omega * s_vec
            r = s_vec - omega * t
            rho = rho_new
            rr = _sdot(r, r)
        it += 1
    return x, it, rr
