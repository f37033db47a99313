"""Distributed (row-partitioned) SpMV / SpMM / CG over a device mesh.

Port of ``libhpc_tpu/parallel/dist_spmv.py``. The matrix is
row-partitioned over the mesh axis; each shard holds

  diag  the block of columns the shard also owns x for (local compute)
  offd  every other column, with global column indices (gathered x)

The overlap discipline is the reference's: start the all_gather of x
(``async_op=True``), compute ``diag @ x_local`` while it is in flight, then
wait and let the off-diagonal part consume the gathered vector.

``DistCSR.from_scipy`` builds the reference's stacked host arrays (leading
dimension = shards) on every rank; ``.shard(mesh)`` keeps this rank's slice
on the mesh's device; ``dist_spmv_fn`` returns this rank's matvec.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.parallel.collectives import all_gather, all_reduce_sum
from libhpc_tpu_torch.parallel.mesh import mesh_device
from libhpc_tpu_torch.sparse._leaves import TensorLeaves, tensor_from_numpy


@dataclasses.dataclass(frozen=True)
class DistCSR(TensorLeaves):
    """Row-partitioned CSR, stacked over shards (leading dim = n_shards;
    1 after ``shard``).

    diag_*: local-column block CSR (indices are local columns)
    offd_*: remaining columns as CSR with global column indices
    Per-shard nnz is padded to the max across shards with (col 0, val 0).
    """

    diag_data: torch.Tensor    # (S, nnz_d)
    diag_indices: torch.Tensor
    diag_indptr: torch.Tensor  # (S, rows_local + 1)
    offd_data: torch.Tensor    # (S, nnz_o)
    offd_indices: torch.Tensor
    offd_indptr: torch.Tensor
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))

    @property
    def rows_local(self) -> int:
        return self.diag_indptr.shape[1] - 1

    @staticmethod
    def from_scipy(sp, n_shards: int) -> "DistCSR":
        """The stacked host arrays (CPU tensors), as the reference's."""
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

        diag, offd = [], []
        for s in range(n_shards):
            r0, r1 = s * rows_local, (s + 1) * rows_local
            blk = sp[r0:r1, :].tocsc()
            d = blk[:, r0:r1].tocsr()
            o = sps.hstack(
                [blk[:, :r0], sps.csr_matrix((rows_local, r1 - r0)),
                 blk[:, r1:]]
            ).tocsr()
            d.sort_indices()
            o.sort_indices()
            diag.append(d)
            offd.append(o)

        def stack(mats):
            nnz_max = max(1, max(m.nnz for m in mats))
            data = np.zeros((n_shards, nnz_max), mats[0].dtype)
            idx = np.zeros((n_shards, nnz_max), np.int32)
            ptr = np.zeros((n_shards, rows_local + 1), np.int32)
            for s, m in enumerate(mats):
                data[s, : m.nnz] = m.data
                idx[s, : m.nnz] = m.indices
                ptr[s] = m.indptr
            return tuple(map(stacked_leaf, (data, idx, ptr)))

        dd, di, dp = stack(diag)
        od, oi, op = stack(offd)
        return DistCSR(
            diag_data=dd, diag_indices=di, diag_indptr=dp,
            offd_data=od, offd_indices=oi, offd_indptr=op,
            shape=(nr, nc), n_shards=n_shards,
        )

    def shard(self, mesh, axis: str = "x") -> "DistCSR":
        """This rank's slice (leading dim 1) on the mesh's device."""
        return shard_leaves(self, mesh, axis)


def stacked_leaf(a: np.ndarray) -> torch.Tensor:
    """A stacked host array as the reference's ``jnp.asarray`` keeps it
    (64-bit JAX off): float64 as float32, int64 as int32. scipy's hstack
    with a float64 zero block makes the off-diagonal data float64."""
    a = np.asarray(a)
    return tensor_from_numpy(a.astype({np.dtype(np.float64): np.float32,
                                       np.dtype(np.int64): np.int32}
                                      .get(a.dtype, a.dtype)))


def shard_leaves(container, mesh, axis: str, device=None):
    """`container` with each stacked tensor leaf cut to this rank's slice
    along `axis` (leading dim 1) and moved to `device` (the mesh's by
    default)."""
    n = mesh.shape[mesh.mesh_dim_names.index(axis)]
    if container.n_shards != n:
        raise ValueError(f"{container.n_shards} shards on a mesh axis of "
                         f"{n} ranks")
    i = mesh.get_local_rank(axis)
    dev = mesh_device(mesh) if device is None else device
    cut = {}
    for f in dataclasses.fields(container):
        v = getattr(container, f.name)
        if isinstance(v, torch.Tensor) and not f.metadata.get("static"):
            cut[f.name] = v[i:i + 1].to(dev)
    return dataclasses.replace(container, **cut)


def _row_ids(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Row of each stored entry; the padded tail past indptr[-1] gets the
    extra row rows_local, which the sums below drop (as the reference's
    segment_sum drops out-of-range segments)."""
    pos = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return torch.searchsorted(indptr, pos, right=True) - 1


def _local_spmm(data, indices, rows, B, nrows):
    prod = data.reshape((-1,) + (1,) * (B.ndim - 1)) * B[indices]
    out = prod.new_zeros((nrows + 1,) + tuple(B.shape[1:]))
    return out.index_add_(0, rows, prod)[:nrows]


def _local_operators(A: DistCSR):
    """(diag, offd) as (data, indices, rows) of this rank's shard."""
    ops = []
    for data, idx, ptr in ((A.diag_data, A.diag_indices, A.diag_indptr),
                           (A.offd_data, A.offd_indices, A.offd_indptr)):
        if data.shape[0] != 1:
            raise ValueError("call .shard(mesh) first: the container holds "
                             f"{data.shape[0]} shards")
        ops.append((data[0], idx[0].long(), _row_ids(ptr[0],
                                                     data.shape[1]).long()))
    return ops


def dist_spmv_fn(A: DistCSR, mesh, axis: str = "x"):
    """This rank's distributed matvec: x_local (rows_local,) -> y_local.

    The all_gather of x is started first; the diagonal block (local x)
    runs while it is in flight; the off-diagonal block then consumes the
    gathered vector."""
    rows_local = A.rows_local
    (dd, di, dr), (od, oi, orr) = _local_operators(A)

    def matvec(x):
        x_l = x.reshape(-1)
        xg, work = all_gather(x_l, axis, mesh=mesh, async_op=True)
        y = _local_spmm(dd, di, dr, x_l, rows_local)
        work.wait()
        return y + _local_spmm(od, oi, orr, xg, rows_local)

    return matvec


def global_dot(axis: str, mesh):
    """<x, y> over every shard of `axis`: the local sum, all-reduced, so
    that every rank holds the same value (and the solvers' loops end at
    the same iteration on every rank)."""
    from libhpc_tpu_torch.ops.solver import _sdot

    def sdot(x, y):
        return all_reduce_sum(_sdot(x, y), axis, mesh=mesh)

    return sdot


def dist_cg(A: DistCSR, b, mesh, axis: str = "x", tol: float = 1e-6,
            max_iter: int = 1000):
    """Distributed CG on this rank's shard b: the matvec is the overlapped
    dist SpMV and every dot product is summed over the mesh axis.
    Returns (x_local, iters, res2), iters and res2 equal on every rank."""
    from libhpc_tpu_torch.ops.solver import _cg

    return _cg(dist_spmv_fn(A, mesh, axis), b, None, tol, max_iter,
               global_dot(axis, mesh))


def dist_spmm_fn(A: DistCSR, mesh, n_cols: int, axis: str = "x"):
    """Distributed SpMM: rows of A partitioned, B (rows_local, c) this
    rank's row shard; returns this rank's (rows_local, c) of A @ B. Same
    diag/offd overlap as dist_spmv_fn."""
    rows_local = A.rows_local
    (dd, di, dr), (od, oi, orr) = _local_operators(A)

    def matmat(B):
        Bg, work = all_gather(B, axis, mesh=mesh, async_op=True)
        Y = _local_spmm(dd, di, dr, B, rows_local)
        work.wait()
        return Y + _local_spmm(od, oi, orr, Bg, rows_local)

    return matmat
