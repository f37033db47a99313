"""Geometric multigrid (V-cycle) for the 2D Poisson model problem.

Port of ``libhpc_tpu/ops/multigrid.py``: weighted-Jacobi smoothing, the
5-point matrix-free operator, full-weighting restriction and bilinear
prolongation (strided slices, no gather), in two hierarchies:

  vertex-centred  interior grids of n = 2^k - 1; coarse point (i, j) sits
                  at fine (2i+1, 2j+1); A_h u = (4u - sum of neighbours) / h^2
                  with zero Dirichlet boundary (poisson2d(n) / h^2);
  cell-centred    grids of 2^k; reflective ghost cells put the Dirichlet
                  boundary on the cell faces, so every level discretizes
                  the same problem.

The reference computes these in plain ``jnp``, so the port computes them
with torch ops: ``.at[].set`` becomes strided assignment into a new
tensor, ``fori_loop`` a Python loop, and the V-cycle's recursion stays
recursion. ``mg_solve`` / ``mg_solve_cc`` return ``(u, res_norm)`` with
``res_norm`` a 0-d tensor on u's device: the solve makes no host sync. A
numpy right-hand side goes to ``device`` (default ``"cuda"``); a torch
tensor stays on its own device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from libhpc_tpu_torch.ops._cuda_utils import as_tensor


def _pad1(u: torch.Tensor) -> torch.Tensor:
    return F.pad(u, (1, 1, 1, 1))


def poisson_op(u, h: float):
    """A_h u for the 5-point Laplacian on spacing h (zero Dirichlet)."""
    up = _pad1(u)
    return (
        4.0 * u
        - up[:-2, 1:-1]
        - up[2:, 1:-1]
        - up[1:-1, :-2]
        - up[1:-1, 2:]
    ) / (h * h)


def restrict_fw(r):
    """Full-weighting restriction (2m+1)^2 -> m^2."""
    c = r[1::2, 1::2]
    n_ = r[0:-1:2, 1::2]
    s_ = r[2::2, 1::2]
    w_ = r[1::2, 0:-1:2]
    e_ = r[1::2, 2::2]
    nw = r[0:-1:2, 0:-1:2]
    ne = r[0:-1:2, 2::2]
    sw = r[2::2, 0:-1:2]
    se = r[2::2, 2::2]
    return (4.0 * c + 2.0 * (n_ + s_ + w_ + e_) + (nw + ne + sw + se)) / 16.0


def prolong_bilinear(e):
    """Bilinear prolongation m^2 -> (2m+1)^2 (zero Dirichlet halo)."""
    m = e.shape[0]
    n = 2 * m + 1
    ep = _pad1(e)  # (m+2, m+2), zero boundary
    out = e.new_zeros((n, n))
    out[1::2, 1::2] = e
    # edge midpoints between vertically adjacent coarse points
    out[0::2, 1::2] = 0.5 * (ep[:-1, 1:-1] + ep[1:, 1:-1])    # (m+1, m)
    out[1::2, 0::2] = 0.5 * (ep[1:-1, :-1] + ep[1:-1, 1:])    # (m, m+1)
    # face centres: average of 4 coarse neighbours
    out[0::2, 0::2] = 0.25 * (ep[:-1, :-1] + ep[:-1, 1:] + ep[1:, :-1]
                              + ep[1:, 1:])
    return out


def smooth_jacobi(u, f, h: float, n_iter: int, omega: float = 0.8):
    inv_d = omega * (h * h) / 4.0
    for _ in range(n_iter):
        u = u + inv_d * (f - poisson_op(u, h))
    return u


def v_cycle(u, f, h: float, pre: int = 2, post: int = 2,
            coarse_iters: int = 32):
    """One V-cycle, recursing down to a 1-3 point coarsest grid solved by
    smoothing."""
    n = u.shape[0]
    if n <= 3:
        return smooth_jacobi(u, f, h, coarse_iters)
    u = smooth_jacobi(u, f, h, pre)
    r = f - poisson_op(u, h)
    rc = restrict_fw(r)
    ec = v_cycle(torch.zeros_like(rc), rc, 2.0 * h, pre, post, coarse_iters)
    u = u + prolong_bilinear(ec)
    return smooth_jacobi(u, f, h, post)


def mg_solve(f, h: float = 1.0, n_cycles: int = 10, pre: int = 2,
             post: int = 2, *, device="cuda"):
    """n_cycles V-cycles from a zero initial guess. Returns (u, res_norm)."""
    f = as_tensor(f, device)
    u = torch.zeros_like(f)
    for _ in range(n_cycles):
        u = v_cycle(u, f, h, pre, post)
    res = f - poisson_op(u, h)
    return u, torch.sqrt(torch.sum(res * res))


# ---------------------------------------------------------------------------
# Cell-centred hierarchy (2^k grids): every level halves evenly.
# ---------------------------------------------------------------------------


def poisson_op_cc(u, h: float):
    """Cell-centred 5-point Laplacian with reflective ghost cells
    (u_ghost = -u_edge: homogeneous Dirichlet on the cell faces)."""
    up = _pad1(u)
    up[0, 1:-1] = -u[0, :]
    up[-1, 1:-1] = -u[-1, :]
    up[1:-1, 0] = -u[:, 0]
    up[1:-1, -1] = -u[:, -1]
    return (
        4.0 * u
        - up[:-2, 1:-1]
        - up[2:, 1:-1]
        - up[1:-1, :-2]
        - up[1:-1, 2:]
    ) / (h * h)


def _diag_cc(n, h, dtype, device=None):
    """Diagonal of poisson_op_cc: 4 + (#boundary faces) per cell, / h^2."""
    d = torch.full((n, n), 4.0, dtype=dtype, device=device)
    d[0, :] += 1.0
    d[-1, :] += 1.0
    d[:, 0] += 1.0
    d[:, -1] += 1.0
    return d / (h * h)


def smooth_jacobi_cc(u, f, h: float, n_iter: int, omega: float = 0.8):
    inv_d = omega / _diag_cc(u.shape[0], h, u.dtype, u.device)
    for _ in range(n_iter):
        u = u + inv_d * (f - poisson_op_cc(u, h))
    return u


_W_CC = ((1.0, 3.0, 3.0, 1.0), (3.0, 9.0, 9.0, 3.0),
         (3.0, 9.0, 9.0, 3.0), (1.0, 3.0, 3.0, 1.0))


def restrict_cc(r):
    """Cell-centred restriction (2m)^2 -> m^2: (1/4) P^T for the bilinear P
    below, a 4x4 stencil [[1,3,3,1],[3,9,9,3],[3,9,9,3],[1,3,3,1]]/64
    applied at stride 2."""
    rp = _pad1(r)
    m2 = r.shape[0]
    out = None
    for dy in range(4):
        for dx in range(4):
            term = _W_CC[dy][dx] * rp[dy:dy + m2:2, dx:dx + m2:2]
            out = term if out is None else out + term
    return out / 64.0


def prolong_cc(e):
    """Cell-centred bilinear prolongation m^2 -> (2m)^2: each fine cell
    takes 9/16 from its coarse owner and 3/16, 3/16, 1/16 from the
    neighbours on its near side (zero ghost outside)."""
    m = e.shape[0]
    ep = _pad1(e)
    c = ep[1:-1, 1:-1]
    out = e.new_zeros((2 * m, 2 * m))
    for di in (0, 1):
        vert = ep[2 * di:m + 2 * di, 1:-1][:m, :]
        for dj in (0, 1):
            horiz = ep[1:-1, 2 * dj:m + 2 * dj][:, :m]
            corner = ep[2 * di:m + 2 * di, 2 * dj:m + 2 * dj][:m, :m]
            out[di::2, dj::2] = (9.0 * c + 3.0 * vert + 3.0 * horiz
                                 + corner) / 16.0
    return out


def v_cycle_cc(u, f, h: float, pre: int = 2, post: int = 2,
               coarse_iters: int = 64):
    """Cell-centred V-cycle on a 2^k grid (coarsest <= 4^2 solved by
    smoothing)."""
    n = u.shape[0]
    if n <= 4:
        return smooth_jacobi_cc(u, f, h, coarse_iters)
    u = smooth_jacobi_cc(u, f, h, pre)
    r = f - poisson_op_cc(u, h)
    rc = restrict_cc(r)
    ec = v_cycle_cc(torch.zeros_like(rc), rc, 2.0 * h, pre, post,
                    coarse_iters)
    u = u + prolong_cc(ec)
    return smooth_jacobi_cc(u, f, h, post)


def mg_solve_cc(f, h: float = 1.0, n_cycles: int = 10, pre: int = 2,
                post: int = 2, *, device="cuda"):
    """Cell-centred multigrid on a (2^k)^2 grid. Returns (u, res_norm)."""
    f = as_tensor(f, device)
    u = torch.zeros_like(f)
    for _ in range(n_cycles):
        u = v_cycle_cc(u, f, h, pre, post)
    res = f - poisson_op_cc(u, h)
    return u, torch.sqrt(torch.sum(res * res))
