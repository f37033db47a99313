"""Distributed banded SpMV: row-partitioned DIA with halo exchange.

Port of ``libhpc_tpu/parallel/dist_dia.py``. Each shard owns
``rows_local`` rows and a DIA slice whose column window extends ``maxoff``
past the shard on both sides. One SpMV is then

    halo = edges of x from both neighbours (maxoff elements each, an open
           ring: zeros past the ends)
    y    = dia_spmv(local_band, [left_halo | x_local | right_halo])

with no all_gather: O(maxoff) elements a neighbour instead of O(n) a rank.
The local product is the port's plain ``ops/spmv.py:dia_spmv``, as the
reference's is XLA's. The matrix bandwidth must not pass rows_per_shard
(each halo comes from the immediate neighbour).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.parallel.collectives import permute
from libhpc_tpu_torch.parallel.dist_spmv import (global_dot, shard_leaves,
                                                 stacked_leaf)
from libhpc_tpu_torch.sparse._leaves import TensorLeaves


@dataclasses.dataclass(frozen=True)
class DistDIA(TensorLeaves):
    """data: (n_shards, ndiags, rows_local + 2*maxoff) (1 shard after
    ``shard``); offsets are the local-window offsets (global offset +
    maxoff), the same on every shard."""

    data: torch.Tensor
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    maxoff: int = dataclasses.field(metadata=dict(static=True))

    @property
    def rows_local(self) -> int:
        return self.shape[0] // self.n_shards

    @staticmethod
    def from_scipy(sp, n_shards: int) -> "DistDIA":
        """The stacked host array (a CPU tensor), as the reference's."""
        import scipy.sparse as sps

        sp = sp.tocsr()
        nr, nc = sp.shape
        if nr != nc:
            raise ValueError("row partitioning assumes a square matrix")
        rows_local = -(-nr // n_shards)
        n_pad = rows_local * n_shards
        if n_pad != nr:
            pad = n_pad - nr
            sp = sps.bmat(
                [[sp, None], [None, sps.identity(pad, dtype=sp.dtype)]]
            ).tocsr()
            nr = nc = n_pad

        global_offsets = sorted(int(o) for o in sp.todia().offsets)
        maxoff = max(abs(o) for o in global_offsets) if global_offsets else 0
        if maxoff > rows_local:
            raise ValueError(
                f"matrix bandwidth {maxoff} exceeds rows_per_shard "
                f"{rows_local}; halos would span multiple neighbors"
            )
        width = rows_local + 2 * maxoff
        local_offsets = tuple(o + maxoff for o in global_offsets)

        data = np.zeros((n_shards, len(global_offsets), width), sp.dtype)
        off_index = {o: i for i, o in enumerate(local_offsets)}
        for s in range(n_shards):
            r0, r1 = s * rows_local, (s + 1) * rows_local
            c0, c1 = r0 - maxoff, r1 + maxoff
            c0c, c1c = max(0, c0), min(nc, c1)
            blocks = []
            if c0c - c0:
                blocks.append(sps.csr_matrix((rows_local, c0c - c0),
                                             dtype=sp.dtype))
            blocks.append(sp[r0:r1, c0c:c1c])
            if c1 - c1c:
                blocks.append(sps.csr_matrix((rows_local, c1 - c1c),
                                             dtype=sp.dtype))
            Wd = sps.hstack(blocks).todia()
            for d, o in enumerate(Wd.offsets):
                if int(o) not in off_index:
                    if Wd.data[d].any():
                        raise AssertionError(
                            f"unexpected diagonal {o} in shard {s}")
                    continue
                data[s, off_index[int(o)], : Wd.data.shape[1]] = Wd.data[d]
        return DistDIA(data=stacked_leaf(data), offsets=local_offsets,
                       shape=(nr, nc), n_shards=n_shards, maxoff=maxoff)

    def shard(self, mesh, axis: str = "x") -> "DistDIA":
        """This rank's slice (leading dim 1) on the mesh's device."""
        return shard_leaves(self, mesh, axis)


def dist_dia_spmv_fn(A: DistDIA, mesh, axis: str = "x"):
    """This rank's halo-exchange banded matvec: x_local -> y_local."""
    from libhpc_tpu_torch.ops.spmv import dia_spmv
    from libhpc_tpu_torch.sparse.dia import DIA

    h = A.maxoff
    rows_local = A.rows_local
    if A.data.shape[0] != 1:
        raise ValueError("call .shard(mesh) first: the container holds "
                         f"{A.data.shape[0]} shards")
    dia = DIA(data=A.data[0], offsets=A.offsets,
              shape=(rows_local, rows_local + 2 * h))

    def matvec(x):
        x_l = x.reshape(-1)
        if h > 0:
            # from neighbour i-1 (its last h) and i+1 (its first h)
            left, right = permute([(x_l[-h:], 1), (x_l[:h], -1)], axis,
                                  mesh=mesh)
            x_l = torch.cat([left, x_l, right])
        return dia_spmv(dia, x_l)

    return matvec


def dist_dia_cg(A: DistDIA, b, mesh, axis: str = "x", tol: float = 1e-6,
                max_iter: int = 1000):
    """CG over the halo-exchange matvec, dots summed over the mesh axis.
    Returns (x_local, iters, res2), iters and res2 equal on every rank."""
    from libhpc_tpu_torch.ops.solver import _cg

    return _cg(dist_dia_spmv_fn(A, mesh, axis), b, None, tol, max_iter,
               global_dot(axis, mesh))
