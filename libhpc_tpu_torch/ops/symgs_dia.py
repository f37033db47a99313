"""Multicoloured Gauss–Seidel sweeps over the DIA planes of a 3-D grid
operator: the smoother of ``ops/multigrid_dia.py`` (HPCG's SymGS).

The rows of an nx x ny x nz grid (row = (z ny + y) nx + x) are coloured by
coordinate parity, ``c = x%2 + 2 (y%2) + 4 (z%2)``: no two points of one
colour are neighbours under a 27-point stencil, so all points of a colour
update at once,

    x[i] = (r[i] - sum_{d != centre} A[i, i + o_d] x[i + o_d]) / A[i, i],

and a sweep updates the colours it is given in turn: ``FORWARD`` is 7..0,
``BACKWARD`` 0..7, and a forward sweep followed by a backward one is a
symmetric Gauss–Seidel step. Colour 0 (every coordinate even) holds the
points a coarse grid of half the size takes by injection, and a sweep
leaves a zero residual at the points it updates last: a backward sweep
that ended on colour 0 would hand an injected restriction a zero residual
and the coarse levels nothing to correct, so colour 0 comes last in the
forward sweep and first in the backward.

``sweep`` reads the operator from a ``DiaPallas`` (the planes K4 reads; no
second copy) and updates x in place inside the level's extended x
(``x_ext``, laid out as ``spmv_dia.extend_x`` lays it out: x at
``x_pad_lo``, zeros around it, which ``sweep`` never writes). For CUDA
tensors each colour is one launch of ``csrc/symgs_dia.cu`` (one ctypes call
a sweep); CPU tensors take ``sweep_torch``, which sums each row's
neighbours in another order. ``SYMGS_LAUNCHES`` counts kernel launches: 8
a sweep on a grid of at least 2 points an axis.
"""

from __future__ import annotations

import ctypes
import math

import torch

from libhpc_tpu_torch.ops._cuda_utils import (check_launch, check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)
from libhpc_tpu_torch.ops.spmv import MAX_DIA_OFFSETS
from libhpc_tpu_torch.ops.spmv_dia import DiaPallas, x_ext_len

SYMGS_LAUNCHES = 0

FORWARD = (7, 6, 5, 4, 3, 2, 1, 0)
BACKWARD = FORWARD[::-1]


def colour_parity(c: int) -> tuple:
    """(x, y, z) parity of colour c."""
    return c & 1, (c >> 1) & 1, (c >> 2) & 1


def colour_rows(grid, c: int) -> int:
    """Points of colour c on the grid (nx, ny, nz)."""
    return math.prod((n - p + 1) // 2
                     for n, p in zip(grid, colour_parity(c)))


def _centre(dp: DiaPallas) -> int:
    """Index of the main diagonal among dp's planes."""
    try:
        return dp.coffs.index(dp.x_pad_lo)
    except ValueError:
        raise ValueError("the operator has no main diagonal") from None


def _check_grid(dp: DiaPallas, grid) -> int:
    nx, ny, nz = grid
    m, n = dp.shape
    if m != n or nx * ny * nz != m:
        raise ValueError(f"grid {tuple(grid)} does not match the square "
                         f"operator of shape {dp.shape}")
    return m


def sweep_torch(dp: DiaPallas, grid, x_ext: torch.Tensor, r: torch.Tensor,
                colours=FORWARD) -> None:
    """Plain version of the kernel: for each colour, its rows' neighbour
    values gathered from x_ext at once, times their plane values, summed
    over the planes."""
    nx, ny, nz = grid
    m = _check_grid(dp, grid)
    D, P = len(dp.coffs), dp.x_pad_lo
    centre = _centre(dp)
    others = [d for d in range(D) if d != centre]
    planes = (dp.dflat.reshape(dp.n_tiles, D, dp.T).transpose(0, 1)
              .reshape(D, -1)[:, :m])
    off, diag = planes[others], planes[centre]
    coffs = torch.tensor([dp.coffs[d] for d in others], device=x_ext.device)
    rows = torch.arange(m, device=x_ext.device).view(nz, ny, nx)
    for c in colours:
        px, py, pz = colour_parity(c)
        rc = rows[pz::2, py::2, px::2].reshape(-1)
        acc = (off[:, rc] * x_ext[coffs[:, None] + rc]).sum(0)
        x_ext[P + rc] = (r[rc] - acc) / diag[rc]


def _launch(dp: DiaPallas, grid, x_ext, r, colours, dev) -> int:
    nx, ny, nz = grid
    m = _check_grid(dp, grid)
    D, T = len(dp.coffs), dp.T
    if not 0 < D <= MAX_DIA_OFFSETS:      # csrc/symgs_dia.cu's kMaxD
        raise ValueError(f"{D} diagonals outside 1..{MAX_DIA_OFFSETS}")
    if any(c not in range(8) for c in colours):
        raise ValueError(f"colours {tuple(colours)} outside 0..7")
    check_tensor(dp.dflat, "dflat", dev, (torch.float32,),
                 (dp.n_tiles * D * (T // 128), 128))
    check_tensor(x_ext, "x_ext", dev, (torch.float32,), (x_ext_len(dp),))
    check_tensor(r, "r", dev, (torch.float32,), (m,))
    coffs = (ctypes.c_int * D)(*dp.coffs)
    cols = (ctypes.c_int * max(1, len(colours)))(*colours)
    fn = kernel_fn("symgs_dia_f32", 5, 8)
    with torch.cuda.device(dev):
        rc = fn(dp.dflat.data_ptr(), x_ext.data_ptr(), r.data_ptr(),
                ctypes.addressof(coffs), ctypes.addressof(cols), D, T,
                _centre(dp), dp.x_pad_lo, nx, ny, nz, len(colours),
                current_stream_ptr())
    check_launch(rc, "symgs_dia_f32")
    return sum(colour_rows(grid, c) > 0 for c in colours)


def sweep(dp: DiaPallas, grid, x_ext: torch.Tensor, r: torch.Tensor,
          colours=FORWARD) -> None:
    """Gauss–Seidel over `colours` in turn, x updated in place inside
    `x_ext` (length ``spmv_dia.x_ext_len(dp)``); `r` (m,) float32 is the
    right-hand side and `grid` (nx, ny, nz) the operator's grid."""
    global SYMGS_LAUNCHES
    dev = kernel_device(dp.dflat, x_ext, r)
    if dev.type == "cpu":
        sweep_torch(dp, grid, x_ext, r, colours)
        return
    SYMGS_LAUNCHES += _launch(dp, grid, x_ext, r, tuple(colours), dev)
