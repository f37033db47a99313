"""Collectives over one axis of a device mesh (torch.distributed).

Port of ``libhpc_tpu/parallel/collectives.py``. The reference's functions
run inside ``shard_map`` bodies and name a mesh axis; here they run in
every rank on its own shard, and ``axis`` names a dimension of ``mesh``,
whose process group (``mesh.get_group(axis)``) carries the collective:

  ``lax.psum``                    -> ``all_reduce`` (sum)
  ``lax.all_gather(tiled=True)``  -> ``all_gather`` into one tensor
  ``lax.psum_scatter``            -> ``reduce_scatter``
  ``lax.ppermute``                -> ``batch_isend_irecv`` (``permute``)
  ``lax.axis_index``              -> ``mesh.get_local_rank(axis)``

The inputs are not modified; every function returns a new tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_group(mesh, axis: str):
    """(process group, size, this rank's index) of mesh dimension axis."""
    size = mesh.shape[mesh.mesh_dim_names.index(axis)]
    return mesh.get_group(axis), size, mesh.get_local_rank(axis)


def all_reduce_sum(x: torch.Tensor, axis: str, *, mesh) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, group=mesh.get_group(axis))
    return y


def all_gather(x: torch.Tensor, axis: str, tiled: bool = True, *, mesh,
               async_op: bool = False):
    """Every rank's x joined along a new leading axis (tiled=False) or
    along axis 0 (tiled=True), gathered into one tensor. async_op=True
    returns (tensor, work): wait on work before reading the tensor."""
    g, n, _ = axis_group(mesh, axis)
    x = x.contiguous()
    out = x.new_empty((n,) + tuple(x.shape))
    work = dist.all_gather(list(out.unbind(0)), x, group=g,
                           async_op=async_op)
    if tiled:
        out = out.reshape((n * x.shape[0],) + tuple(x.shape[1:])) \
            if x.ndim else out
    return (out, work) if async_op else out


def reduce_scatter(x: torch.Tensor, axis: str, *, mesh) -> torch.Tensor:
    """Sum of every rank's x, split along axis 0: this rank's part."""
    g, n, _ = axis_group(mesh, axis)
    parts = [p.contiguous() for p in x.chunk(n)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=g)
    return out


def permute(items, axis: str, wrap: bool = False, *, mesh,
            async_op: bool = False):
    """Shifts along `axis`, all in one batch of point-to-point operations.

    items: (tensor, step) pairs; rank i sends its tensor to rank i + step
    and receives into a new tensor from rank i - step (mod the axis size
    with wrap). A rank that receives from nobody gets zeros; a rank with
    nobody to send to sends nothing; a wrapped shift onto itself (a
    one-rank axis) is a local copy. Returns the received tensors, and with
    async_op=True also the list of works to wait on."""
    g, n, i = axis_group(mesh, axis)
    ops, outs = [], []
    for t, step in items:
        t = t.contiguous()
        out = torch.zeros_like(t)
        dst, src = i + step, i - step
        if wrap:
            dst, src = dst % n, src % n
        if wrap and dst == i:
            out.copy_(t)
        else:
            if 0 <= dst < n:
                ops.append(dist.P2POp(dist.isend, t,
                                      dist.get_global_rank(g, dst), g))
            if 0 <= src < n:
                ops.append(dist.P2POp(dist.irecv, out,
                                      dist.get_global_rank(g, src), g))
        outs.append(out)
    works = dist.batch_isend_irecv(ops) if ops else []
    if async_op:
        return outs, works
    for w in works:
        w.wait()
    return outs


def shift_up(x: torch.Tensor, axis: str, wrap: bool = False, *, mesh
             ) -> torch.Tensor:
    """Send the shard to neighbour i+1; receive from i-1 (zeros at the
    boundary unless wrap). The distributed ghost-cell fill."""
    return permute([(x, 1)], axis, wrap, mesh=mesh)[0]


def shift_down(x: torch.Tensor, axis: str, wrap: bool = False, *, mesh
               ) -> torch.Tensor:
    """Send the shard to neighbour i-1; receive from i+1."""
    return permute([(x, -1)], axis, wrap, mesh=mesh)[0]


def my_index(axis: str, *, mesh) -> int:
    return mesh.get_local_rank(axis)
