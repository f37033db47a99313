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
tensors the colours go to ``csrc/symgs_dia.cu`` (one ctypes call a sweep)
in the launches ``colour_launches`` splits them into: two adjacent colours
that differ only in x parity share one launch, in their order, and any
other colour is a launch of its own (``FORWARD`` and ``BACKWARD`` are four
pairs). A pair launch gives the same bits as its two colours launched one
at a time. CPU tensors take ``sweep_torch``, which sums each row's
neighbours in another order. ``SYMGS_LAUNCHES`` counts kernel launches of
either form, 4 a sweep on a grid of at least 2 points an axis, and
``SYMGS_PAIR_LAUNCHES`` the pair launches among them.
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
SYMGS_PAIR_LAUNCHES = 0

# the longest x-line a pair launch takes: csrc/symgs_dia.cu's kMaxPairNx;
# on longer lines a pair runs as its two colours
MAX_PAIR_NX = 512

FORWARD = (7, 6, 5, 4, 3, 2, 1, 0)
BACKWARD = FORWARD[::-1]


def colour_parity(c: int) -> tuple:
    """(x, y, z) parity of colour c."""
    return c & 1, (c >> 1) & 1, (c >> 2) & 1


def colour_rows(grid, c: int) -> int:
    """Points of colour c on the grid (nx, ny, nz)."""
    return math.prod((n - p + 1) // 2
                     for n, p in zip(grid, colour_parity(c)))


def colour_launches(colours) -> tuple:
    """The launches a sweep over `colours` makes on the card, in order:
    two adjacent colours c, c ^ 1 form one pair launch, any other colour
    is a launch alone. ``FORWARD`` gives (7, 6) (5, 4) (3, 2) (1, 0)."""
    colours, out, i = tuple(colours), [], 0
    while i < len(colours):
        n = 2 if colours[i + 1:i + 2] == (colours[i] ^ 1,) else 1
        out.append(colours[i:i + n])
        i += n
    return tuple(out)


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


def _launch(dp: DiaPallas, grid, x_ext, r, colours, dev) -> tuple:
    """Launch `colours` on the card; (launches, pair launches) made."""
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
    launches = (colour_launches(colours) if nx <= MAX_PAIR_NX
                else tuple((c,) for c in colours))
    coffs = (ctypes.c_int * D)(*dp.coffs)
    # csrc/symgs_dia.cu takes a launch as (colour, its pair or -1)
    flat = [c for ls in launches for c in (ls + (-1,))[:2]]
    codes = (ctypes.c_int * max(1, len(flat)))(*flat)
    fn = kernel_fn("symgs_dia_f32", 5, 8)
    with torch.cuda.device(dev):
        rc = fn(dp.dflat.data_ptr(), x_ext.data_ptr(), r.data_ptr(),
                ctypes.addressof(coffs), ctypes.addressof(codes), D, T,
                _centre(dp), dp.x_pad_lo, nx, ny, nz, len(launches),
                current_stream_ptr())
    check_launch(rc, "symgs_dia_f32")
    made = [ls for ls in launches
            if sum(colour_rows(grid, c) for c in ls) > 0]
    return len(made), sum(len(ls) == 2 for ls in made)


def sweep(dp: DiaPallas, grid, x_ext: torch.Tensor, r: torch.Tensor,
          colours=FORWARD) -> None:
    """Gauss–Seidel over `colours` in turn, x updated in place inside
    `x_ext` (length ``spmv_dia.x_ext_len(dp)``); `r` (m,) float32 is the
    right-hand side and `grid` (nx, ny, nz) the operator's grid."""
    global SYMGS_LAUNCHES, SYMGS_PAIR_LAUNCHES
    dev = kernel_device(dp.dflat, x_ext, r)
    if dev.type == "cpu":
        sweep_torch(dp, grid, x_ext, r, colours)
        return
    launches, pairs = _launch(dp, grid, x_ext, r, tuple(colours), dev)
    SYMGS_LAUNCHES += launches
    SYMGS_PAIR_LAUNCHES += pairs
