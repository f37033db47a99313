"""Distributed halo exchange.

Port of ``libhpc_tpu/parallel/halo.py``. The reference's ghost cells
(HPCHighDimensionFlatArray's Low/High bounds) become per-shard halo rows
refreshed from mesh neighbours: the ``ppermute`` pairs of the reference are
one batch of point-to-point sends and receives
(``collectives.permute``). The overlap discipline is the reference's:
start the exchange, compute the interior while it is in flight, then
finish the boundary.

Every function runs in each rank on its own shard ``x``; ``axis`` names a
dimension of ``mesh``.
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.parallel.collectives import permute


def _start_halo_1d(x, halo: int, axis: str, wrap: bool, mesh):
    """Start the exchange of exchange_halo_1d: ((top, bot), works)."""
    return permute([(x[-halo:], 1), (x[:halo], -1)], axis, wrap, mesh=mesh,
                   async_op=True)


def _wait(works) -> None:
    for w in works:
        w.wait()


def exchange_halo_1d(x, halo: int, axis: str, wrap: bool = False, *, mesh):
    """Return (top_halo, bottom_halo) received from row neighbours.

    x: local (rows_local, ...) shard, partitioned along rows over `axis`.
    top_halo: last `halo` rows of the previous shard (zeros at the
    boundary unless wrap); bottom_halo: first `halo` rows of the next."""
    (top, bot), works = _start_halo_1d(x, halo, axis, wrap, mesh)
    _wait(works)
    return top, bot


def pad_with_halo(x, halo: int, axis: str, wrap: bool = False, *, mesh):
    """Local shard extended with neighbour ghost rows: (rows + 2h, ...)."""
    top, bot = exchange_halo_1d(x, halo, axis, wrap, mesh=mesh)
    return torch.cat([top, x, bot], dim=0)


def exchange_to_halo(x, halo: int, axis: str, wrap: bool = False, *, mesh):
    """Local shard -> HaloArray whose leading-dim ghost cells were refreshed
    from mesh neighbours: the distributed ghost-fill policy of the same
    container ``HaloArray.wrap`` fills with a constant, so the stencils of
    ops/stencil.py (``*_halo``) cannot tell them apart."""
    from libhpc_tpu_torch.containers import HaloArray

    lo = (halo,) + (0,) * (x.ndim - 1)
    return HaloArray.from_padded(pad_with_halo(x, halo, axis, wrap,
                                               mesh=mesh), lo, lo,
                                 device=x.device)


def halo_stencil_overlapped(x, stencil_fn, halo: int, axis: str,
                            wrap: bool = False, *, mesh):
    """Apply ``stencil_fn(padded_block) -> block`` with an interior /
    boundary split, so the exchange runs while the interior computes.

    stencil_fn maps an (m + 2h, ...) padded block to the (m, ...) result
    (its output row i uses input rows [i, i + 2h]). Output rows [h, m - h)
    need only local rows; the top and bottom h rows need the halos, which
    are waited on only for those two small blocks."""
    m = x.shape[0]
    h = halo
    if m < 4 * h:
        # shard too thin to split: exchange, then compute
        return stencil_fn(pad_with_halo(x, h, axis, wrap, mesh=mesh))
    (top, bot), works = _start_halo_1d(x, h, axis, wrap, mesh)
    interior = stencil_fn(x)[: m - 2 * h]        # output rows h .. m-h
    _wait(works)
    top_out = stencil_fn(torch.cat([top, x[: 3 * h]], dim=0))[:h]
    bot_out = stencil_fn(torch.cat([x[-3 * h:], bot], dim=0))[-h:]
    return torch.cat([top_out, interior, bot_out], dim=0)


def pad_with_halo_2d(x, halo: int, axes=("py", "px"), wrap: bool = False,
                     *, mesh):
    """2-D domain decomposition: extend the local (my, nx) shard with ghost
    rows and columns from the 4 side neighbours. Corners come with the
    second exchange: rows first, then the columns of the row-extended
    block."""
    ay, ax = axes
    top, bot = exchange_halo_1d(x, halo, ay, wrap, mesh=mesh)
    xr = torch.cat([top, x, bot], dim=0)             # (my + 2h, nx)
    left, right = permute([(xr[:, -halo:], 1), (xr[:, :halo], -1)], ax,
                          wrap, mesh=mesh)
    return torch.cat([left, xr, right], dim=1)
