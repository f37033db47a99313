"""Distributed ghost-cell stencils.

Port of ``libhpc_tpu/parallel/dist_stencil.py``: a 2-D (or 3-D, along its
leading axis) field row-partitioned over the mesh, a stencil applied with
halo exchange and the overlapped interior / boundary split of
``parallel/halo.py``. Each ``dist_*_fn`` returns the function of this
rank's shard; the shared ghost-cell stencils (``box_sum_halo``,
``poisson5_halo``, ``poisson7_halo``) are the single-device ones of
``ops/stencil.py``, fed exchange-filled ghost rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from libhpc_tpu_torch.containers import HaloArray
from libhpc_tpu_torch.ops.stencil import (box_sum_1d, box_sum_halo,
                                          poisson5_halo, poisson7_halo)
from libhpc_tpu_torch.parallel import halo as _halo


def dist_blur2d_fn(mesh, radius: int = 8, axis: str = "x",
                   overlap: bool = True):
    """Distributed 2-D box sum of radius r: this rank's (k, n) row shard
    -> its (k, n) result. The X pass is local; the Y pass crosses shard
    boundaries through the halo exchange."""
    r = radius

    def y_stencil(padded):
        # (k + 2r, n) -> (k, n): one extra zero row gives box_sum_halo's
        # cumsum shift slot (lo >= r + 1)
        h = HaloArray.from_padded(F.pad(padded, (0, 0, 1, 0)),
                                  lo=(r + 1, 0), hi=(r, 0),
                                  device=padded.device)
        return box_sum_halo(h, r, axis=0)

    def blur(x):
        bx = box_sum_1d(x, r, axis=1)          # local lane pass
        if overlap:
            return _halo.halo_stencil_overlapped(bx, y_stencil, r, axis,
                                                 mesh=mesh)
        return y_stencil(_halo.pad_with_halo(bx, r, axis, mesh=mesh))

    return blur


def dist_poisson_fn(mesh, axis: str = "x"):
    """Distributed matrix-free 5-point Poisson operator on this rank's
    (k, n) row shard of the grid."""

    def p5(padded):
        # row ghosts from the exchange, column ghosts zero (Dirichlet)
        h = HaloArray.from_padded(F.pad(padded, (1, 1, 0, 0)),
                                  lo=(1, 1), hi=(1, 1), device=padded.device)
        return poisson5_halo(h)

    def apply(x):
        return _halo.halo_stencil_overlapped(x, p5, 1, axis, mesh=mesh)

    return apply


def dist_poisson3d_fn(mesh, axis: str = "x"):
    """Distributed matrix-free 7-point 3-D Poisson on a (z, y, x) grid
    sharded along its leading z axis."""

    def p7(padded):
        h = HaloArray.from_padded(F.pad(padded, (1, 1, 1, 1, 0, 0)),
                                  lo=(1, 1, 1), hi=(1, 1, 1),
                                  device=padded.device)
        return poisson7_halo(h)

    def apply(x):
        top, bot = _halo.exchange_halo_1d(x.reshape(x.shape[0], -1), 1,
                                          axis, mesh=mesh)
        return p7(torch.cat([top.reshape(1, *x.shape[1:]), x,
                             bot.reshape(1, *x.shape[1:])], dim=0))

    return apply


def dist_poisson_2dmesh_fn(mesh, axes=("py", "px")):
    """5-point Poisson on a grid sharded over both axes of a 2-D mesh
    (2-D domain decomposition: halo rows, columns and corners)."""

    def apply(x):
        p = _halo.pad_with_halo_2d(x, 1, axes, mesh=mesh)
        return poisson5_halo(HaloArray.from_padded(p, (1, 1), (1, 1),
                                                   device=p.device))

    return apply
