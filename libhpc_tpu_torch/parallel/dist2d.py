"""2-D block-partitioned distributed SpMV (SUMMA-style).

Port of ``libhpc_tpu/parallel/dist2d.py``. The matrix is split into a
(Pr x Pc) block grid over a ("py", "px") mesh; x is sharded along "px" and
replicated along "py". One SpMV:

    partial_i = A_{i,j} @ x_j            (local, each rank)
    y_i       = sum over px of partial_i (all_reduce over the px group)

y comes back sharded over "py" and replicated over "px", the transpose of
x's distribution; ``realign=True`` turns it back into x's (an all_gather
over "py", then this rank's px block).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.parallel.collectives import all_gather, all_reduce_sum
from libhpc_tpu_torch.parallel.dist_spmv import (_local_spmm, _row_ids,
                                                 stacked_leaf)
from libhpc_tpu_torch.parallel.mesh import mesh_device
from libhpc_tpu_torch.sparse._leaves import TensorLeaves


@dataclasses.dataclass(frozen=True)
class Dist2DCSR(TensorLeaves):
    """CSR blocks stacked over a (Pr, Pc) grid (1 x 1 after ``shard``);
    per-block nnz padded to the global max."""

    data: torch.Tensor     # (Pr, Pc, nnz_max)
    indices: torch.Tensor  # (Pr, Pc, nnz_max) local column indices
    indptr: torch.Tensor   # (Pr, Pc, rows_local + 1)
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    grid: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def rows_local(self) -> int:
        return self.indptr.shape[2] - 1

    @property
    def cols_local(self) -> int:
        return self.shape[1] // self.grid[1]

    @staticmethod
    def from_scipy(sp, grid: tuple) -> "Dist2DCSR":
        """The stacked host arrays (CPU tensors), as the reference's."""
        import scipy.sparse as sps

        pr, pc = grid
        sp = sp.tocsr()
        nr, nc = sp.shape
        rows_local = -(-nr // pr)
        cols_local = -(-nc // pc)
        nrp, ncp = rows_local * pr, cols_local * pc
        if (nrp, ncp) != (nr, nc):
            sp = sps.csr_matrix(
                sps.vstack([
                    sps.hstack([sp, sps.csr_matrix((nr, ncp - nc),
                                                   dtype=sp.dtype)]),
                    sps.csr_matrix((nrp - nr, ncp), dtype=sp.dtype),
                ])
            )
        blocks = [[sp[i * rows_local:(i + 1) * rows_local,
                      j * cols_local:(j + 1) * cols_local].tocsr()
                   for j in range(pc)] for i in range(pr)]
        nnz_max = max(1, max(b.nnz for row in blocks for b in row))
        data = np.zeros((pr, pc, nnz_max), sp.dtype)
        idx = np.zeros((pr, pc, nnz_max), np.int32)
        ptr = np.zeros((pr, pc, rows_local + 1), np.int32)
        for i in range(pr):
            for j in range(pc):
                b = blocks[i][j]
                b.sort_indices()
                data[i, j, : b.nnz] = b.data
                idx[i, j, : b.nnz] = b.indices
                ptr[i, j] = b.indptr
        return Dist2DCSR(data=stacked_leaf(data), indices=stacked_leaf(idx),
                         indptr=stacked_leaf(ptr), shape=(nrp, ncp),
                         grid=tuple(grid))

    def shard(self, mesh, axes=("py", "px")) -> "Dist2DCSR":
        """This rank's block (leading dims 1 x 1) on the mesh's device."""
        i, j = (mesh.get_local_rank(a) for a in axes)
        dev = mesh_device(mesh)
        return dataclasses.replace(
            self, **{k: getattr(self, k)[i:i + 1, j:j + 1].to(dev)
                     for k in ("data", "indices", "indptr")})


def dist2d_spmv_fn(A: Dist2DCSR, mesh, axes=("py", "px"),
                   realign: bool = True):
    """This rank's 2-D matvec. Input: this rank's px block of x
    (cols_local,). Output: realign=True, its px block of y (x's
    distribution, usable in solvers); realign=False, its py block.

    realign needs a square block grid (rows_local == cols_local)."""
    ay, ax = axes
    rows_local = A.rows_local
    if realign and rows_local != A.cols_local:
        raise ValueError(
            "realign=True needs a square block grid (rows_local == "
            f"cols_local), got {rows_local} vs {A.cols_local}"
        )
    if A.data.shape[:2] != (1, 1):
        raise ValueError("call .shard(mesh) first: the container holds "
                         f"{tuple(A.data.shape[:2])} blocks")
    data, idx = A.data[0, 0], A.indices[0, 0].long()
    rows = _row_ids(A.indptr[0, 0], data.shape[0]).long()

    def matvec(x):
        part = _local_spmm(data, idx, rows, x.reshape(-1), rows_local)
        y = all_reduce_sum(part, ax, mesh=mesh)    # row-wise over px
        if realign:
            # full y on every rank of a px column, then the px-th block
            yg = all_gather(y, ay, mesh=mesh)
            j = mesh.get_local_rank(ax)
            y = yg[j * rows_local:(j + 1) * rows_local]
        return y

    return matvec
