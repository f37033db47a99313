"""Plain reference of hpcg_mg_256: HPCG's multigrid-preconditioned CG,
matrix-free, written from the HPCG Technical Specification (SAND2013-8752)
and HPCG 3.1's reference code (ComputeMG_ref, ComputeSYMGS_ref,
ComputeRestriction_ref, ComputeProlongation_ref, CG_ref).

- The operator on every level is the 27-point stencil on that level's
  grid (the diagonal, and the off-diagonal value at each neighbour inside
  the grid): ``reference/hpcg_27pt_256.py``'s box sum. Level k's grid is
  the fine grid halved k times on every axis (GenerateCoarseProblem).
- SymGS: a forward Gauss–Seidel sweep, then a backward one, in the
  configuration's stated order: points coloured by coordinate parity,
  c = x%2 + 2 (y%2) + 4 (z%2), the forward sweep over colours 7..0 and the
  backward over 0..7, all points of a colour at once (no two are
  neighbours). Each colour forms its neighbour sums on its own points only.
  Colour 0 holds the coarse grid's points: updated last by the backward
  sweep, they would carry a zero residual into the restriction.
- The V-cycle from x = 0: SymGS, the residual injected to the coarse grid
  (coarse point (x, y, z) takes fine point (2x, 2y, 2z)), the V-cycle
  there, its x added back at those points, SymGS; the coarsest level one
  SymGS.
- PCG: textbook preconditioned CG from x0 = 0 for a fixed number of
  iterations.

Every step runs in the dtype asked for: float64 for the reference,
bfloat16 for the control. There is no matrix product, so TF32 does not
arise. Nothing here imports the program.
"""

from __future__ import annotations

import types

import torch

from hpcbench.reference import hpcg_27pt_256

COLOURS = tuple(range(7, -1, -1))     # the forward sweep's order


def _grids(s: dict) -> list:
    return [(s["nx"] >> k, s["ny"] >> k, s["nz"] >> k)
            for k in range(s["levels"])]


def operator(inputs, dtype: torch.dtype, device):
    """The fine level's 27-point operator, v -> A v."""
    return hpcg_27pt_256.operator(inputs, dtype, device)


def _level_operator(s: dict, grid, dtype, device):
    nx, ny, nz = grid
    sizes = dict(s, nx=nx, ny=ny, nz=nz)
    return hpcg_27pt_256.operator(types.SimpleNamespace(sizes=sizes), dtype,
                                  device)


def _sweep(xp, r, colours, diag: float, off: float) -> None:
    """Gauss–Seidel over `colours` in turn: xp is the zero-padded
    (nz+2, ny+2, nx+2) grid of x, updated in place inside its border."""
    nz, ny, nx = (n - 2 for n in xp.shape)
    x = xp[1:-1, 1:-1, 1:-1]
    for c in colours:
        px, py, pz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        hx, hy, hz = ((n - p + 1) // 2 for n, p in
                      ((nx, px), (ny, py), (nz, pz)))
        # the 3 x 3 x 3 box of the padded grid at this colour's points,
        # axis by axis
        b = sum(xp[:, :, px + d:px + d + 2 * hx:2] for d in range(3))
        b = sum(b[:, py + d:py + d + 2 * hy:2] for d in range(3))
        b = sum(b[pz + d:pz + d + 2 * hz:2] for d in range(3))
        sub = (slice(pz, None, 2), slice(py, None, 2), slice(px, None, 2))
        x[sub] = (r[sub] - off * (b - x[sub])) / diag


def _symgs(xp, r, diag, off) -> None:
    _sweep(xp, r, COLOURS, diag, off)
    _sweep(xp, r, COLOURS[::-1], diag, off)


def vcycle(inputs, dtype: torch.dtype, device):
    """M: r -> z, HPCG's V-cycle from x = 0, on flat vectors of the fine
    grid."""
    s = inputs.sizes
    grids = _grids(s)
    diag, off = s["diagonal"], s["off_diagonal"]
    ops = [_level_operator(s, g, dtype, device) for g in grids]

    def cycle(k, r):
        nx, ny, nz = grids[k]
        xp = torch.zeros((nz + 2, ny + 2, nx + 2), dtype=dtype,
                         device=device)
        x = xp[1:-1, 1:-1, 1:-1]
        _symgs(xp, r, diag, off)
        if k + 1 < len(grids):
            res = r - ops[k](x).reshape(nz, ny, nx)
            x[::2, ::2, ::2] += cycle(k + 1, res[::2, ::2, ::2])
            _symgs(xp, r, diag, off)
        return x

    def apply(v: torch.Tensor) -> torch.Tensor:
        nx, ny, nz = grids[0]
        r = v.to(device=device, dtype=dtype).reshape(nz, ny, nx)
        return cycle(0, r).reshape(-1)

    return apply


def pcg(op, minv, b: torch.Tensor, iterations: int) -> torch.Tensor:
    """Textbook PCG from x0 = 0 for `iterations` iterations, in b's
    dtype."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = minv(r)
    p = z.clone()
    rz = torch.dot(r, z)
    for _ in range(iterations):
        q = op(p)
        alpha = rz / torch.dot(p, q)
        x += alpha * p
        r -= alpha * q
        z = minv(r)
        rz_next = torch.dot(r, z)
        p = z + (rz_next / rz) * p
        rz = rz_next
    return x


def solver(inputs, dtype: torch.dtype, device):
    """This PCG with this V-cycle as a solver with the program's signature,
    computed in `dtype` (the control puts it in the program's place): the
    operator is the matvec it is given; returns (x, iterations, None)."""
    minv = vcycle(inputs, dtype, device)

    def solve(matvec, b, tol=0.0, max_iter=50):
        return pcg(matvec, minv, b.to(dtype), max_iter), max_iter, None

    return solve
