"""HPCG's geometric multigrid over DIA levels: the V-cycle of HPCG's
``ComputeMG_ref``, with a multicoloured symmetric Gauss–Seidel smoother.

A ``DiaMultigrid`` holds, for each level of a hierarchy of 3-D grids (each
coarse grid halves every axis of the one above), the level's operator as a
``DiaPallas`` (the container K4 applies) and its work vectors, allocated
once. The caller generates every level's operator, as HPCG's
``GenerateCoarseProblem`` does (the stencil on the coarse grid, not a
Galerkin product), and passes the scipy matrices with their grids.

``vcycle(h, r)`` returns z = M r, from x = 0 on every level:

  1. x = 0; one SymGS (``symgs``: a forward sweep of the colours 7..0 and
     a backward one 0..7, ``ops/symgs_dia.py``);
  2. the residual through K4 (``spmv_dia.dia_out`` on the level's
     extended x, which already holds x in K4's layout), restricted by
     injection: ``rc = (r - A x)[f2c]``, f2c taking coarse point (x, y, z)
     to fine point (2x, 2y, 2z);
  3. the V-cycle on the coarse level, prolonged by injection: ``x[f2c] +=
     xc``;
  4. one SymGS more; the coarsest level gets one SymGS alone.

Pre- and post-smoother are the same symmetric step, so M is symmetric and
``solver.pcg_op(matvec, lambda r: vcycle(h, r), b, ...)`` is a valid PCG.
Restriction and prolongation are strided views of the (nz, ny, nx) grid.
CPU tensors take the plain paths of K4 and of the sweep; CUDA tensors their
kernels. While a profiler records, each top-level call is one
``libhpc.mg.vcycle`` range and each SymGS one ``libhpc.mg.smooth`` range;
``MG_VCYCLES`` counts top-level calls.
"""

from __future__ import annotations

import dataclasses

import torch

from libhpc_tpu_torch.ops import symgs_dia
from libhpc_tpu_torch.ops.spmv_dia import DiaPallas, dia_out, x_ext_len
from libhpc_tpu_torch.sparse.dia import DIA
from libhpc_tpu_torch.utils.profiling import MG_SMOOTH, MG_VCYCLE, annotate

MG_VCYCLES = 0

# the largest tile K4 takes a level in (ops/spmv_dia.py's default)
MAX_TILE = 1 << 17


@dataclasses.dataclass
class MGLevel:
    """One level: its operator, its grid (nx, ny, nz) and, below the
    finest, its extended x and its right-hand side (the finest level's x
    is the V-cycle's output, new each call, and its r the caller's)."""

    dp: DiaPallas
    grid: tuple
    x_ext: torch.Tensor | None
    r: torch.Tensor | None

    @property
    def rows(self) -> int:
        return self.dp.shape[0]

    def x(self, x_ext: torch.Tensor) -> torch.Tensor:
        """The level's x inside `x_ext`, a view."""
        P = self.dp.x_pad_lo
        return x_ext[P:P + self.rows]


@dataclasses.dataclass
class DiaMultigrid:
    levels: list

    @staticmethod
    def from_scipy(mats, grids, device="cuda") -> "DiaMultigrid":
        """One level a (scipy matrix, (nx, ny, nz)) pair, finest first;
        each coarse grid is the one above halved on every axis. Each
        level's tile is the smaller of ``MAX_TILE`` and its rows rounded up
        to 128, so a coarse level stores no whole tile of padding."""
        grids = [tuple(int(n) for n in g) for g in grids]
        if len(mats) != len(grids) or not grids:
            raise ValueError("one grid a level")
        for fine, coarse in zip(grids, grids[1:]):
            if any(f % 2 or f // 2 != c for f, c in zip(fine, coarse)):
                raise ValueError(f"grid {coarse} is not {fine} halved")
        levels = []
        for k, (A, grid) in enumerate(zip(mats, grids)):
            rows = grid[0] * grid[1] * grid[2]
            if A.shape != (rows, rows):
                raise ValueError(f"level {k}: shape {A.shape} for grid "
                                 f"{grid}")
            T = min(MAX_TILE, -(-rows // 128) * 128)
            dp = DiaPallas.from_dia(DIA.from_scipy(A, device="cpu"), T=T,
                                    device=device)
            x_ext = r = None
            if k:
                x_ext = torch.zeros(x_ext_len(dp), dtype=torch.float32,
                                    device=device)
                r = torch.zeros(rows, dtype=torch.float32, device=device)
            levels.append(MGLevel(dp, grid, x_ext, r))
        return DiaMultigrid(levels)


def symgs(lv: MGLevel, x_ext: torch.Tensor, r: torch.Tensor) -> None:
    """One symmetric Gauss–Seidel step on level `lv`, x in place."""
    with annotate(MG_SMOOTH):
        symgs_dia.sweep(lv.dp, lv.grid, x_ext, r, symgs_dia.FORWARD)
        symgs_dia.sweep(lv.dp, lv.grid, x_ext, r, symgs_dia.BACKWARD)


def _grid(v: torch.Tensor, grid) -> torch.Tensor:
    nx, ny, nz = grid
    return v.view(nz, ny, nx)


_F2C = (slice(None, None, 2),) * 3


def restrict(lv: MGLevel, coarse: MGLevel, r, Ax) -> None:
    """coarse.r = (r - A x) at the coarse points (injection)."""
    torch.sub(_grid(r, lv.grid)[_F2C], _grid(Ax, lv.grid)[_F2C],
              out=_grid(coarse.r, coarse.grid))


def prolong(lv: MGLevel, x, coarse: MGLevel, xc) -> None:
    """x += xc at the coarse points (injection)."""
    _grid(x, lv.grid)[_F2C] += _grid(xc, coarse.grid)


def _cycle(h: DiaMultigrid, k: int, r: torch.Tensor) -> torch.Tensor:
    lv = h.levels[k]
    if lv.x_ext is None:
        x_ext = torch.zeros(x_ext_len(lv.dp), dtype=torch.float32,
                            device=lv.dp.dflat.device)
    else:
        x_ext = lv.x_ext
        x_ext.zero_()
    x = lv.x(x_ext)
    symgs(lv, x_ext, r)
    if k + 1 == len(h.levels):
        return x
    coarse = h.levels[k + 1]
    restrict(lv, coarse, r, dia_out(lv.dp, x_ext).reshape(-1)[:lv.rows])
    prolong(lv, x, coarse, _cycle(h, k + 1, coarse.r))
    symgs(lv, x_ext, r)
    return x


def vcycle(h: DiaMultigrid, r: torch.Tensor) -> torch.Tensor:
    """z = M r: one V-cycle from x = 0 for the finest level's r (float32,
    contiguous); z is a new tensor."""
    global MG_VCYCLES
    with annotate(MG_VCYCLE):
        z = _cycle(h, 0, r)
    MG_VCYCLES += 1
    return z
