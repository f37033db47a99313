"""CSR sparse matrix of torch tensors.

Port of ``libhpc_tpu/sparse/csr.py:CSR``: the interchange container of the
main path's CSR half, with int32 indices and scipy bridges for oracle
testing, the COO bridges ``from_coo`` / ``tocoo``, and ``to_ell`` /
``to_bsr``. The builders build on the host and move the leaves to
``device`` (default ``"cuda"``) once at the end; ``device="cpu"`` keeps
them on the CPU. ``from_coo`` sorts and segments on the COO's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.ops._cuda_utils import as_tensor
from libhpc_tpu_torch.sparse._leaves import TensorLeaves, tensor_from_numpy


@dataclasses.dataclass(frozen=True)
class CSR(TensorLeaves):
    """Compressed sparse row matrix.

    indptr: int32 (nrows+1,), indices: int32 (nnz,), data: (nnz,).
    Explicit zero padding entries (col 0, value 0) are permitted — all ops
    are additive so padding is harmless.
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_scipy(sp, device="cuda") -> "CSR":
        """Build on the host, then move the leaves to ``device`` once."""
        sp = sp.tocsr()
        sp.sort_indices()
        return CSR(
            data=tensor_from_numpy(sp.data),
            indices=tensor_from_numpy(sp.indices.astype(np.int32)),
            indptr=tensor_from_numpy(sp.indptr.astype(np.int32)),
            shape=tuple(sp.shape),
        ).to(device)

    def to_scipy(self):
        import scipy.sparse as sps

        leaves = self.to_numpy()
        return sps.csr_matrix(
            (leaves["data"], leaves["indices"], leaves["indptr"]),
            shape=self.shape)

    @staticmethod
    def from_dense(mat, device="cuda") -> "CSR":
        import scipy.sparse as sps

        return CSR.from_scipy(sps.csr_matrix(np.asarray(mat)), device=device)

    @staticmethod
    def from_coo(coo) -> "CSR":
        """Row-sort the COO triplets and build indptr by searchsorted: one
        sort and one vectorized search instead of per-element inserts
        (libHPC's HashBlock.hpp:92-102)."""
        c = coo.sort_indices("row")
        nrows = coo.shape[0]
        bounds = torch.arange(nrows + 1, dtype=torch.int32,
                              device=c.row.device)
        indptr = torch.searchsorted(c.row, bounds).to(torch.int32)
        return CSR(data=c.data, indices=c.col, indptr=indptr,
                   shape=coo.shape)

    def tocoo(self):
        from libhpc_tpu_torch.sparse.coo import COO

        return COO(row=self.row_of_nnz(), col=self.indices, data=self.data,
                   shape=self.shape)

    # -- derived index structures -----------------------------------------

    def row_of_nnz(self) -> torch.Tensor:
        """int32 (nnz,): the row index of every stored element — for each
        nnz position p, the row r with indptr[r] <= p < indptr[r+1]."""
        pos = torch.arange(self.nnz, dtype=torch.int32,
                           device=self.indptr.device)
        return (torch.searchsorted(self.indptr, pos, right=True)
                .to(torch.int32) - 1)

    def row_lengths(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def max_row_length(self) -> int:
        """Host-side max nnz/row (concrete int; pulls one scalar)."""
        return int(torch.max(self.row_lengths()))

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.data.device)
        return out.index_put_((self.row_of_nnz().long(),
                               self.indices.long()), self.data,
                              accumulate=True)

    # -- format conversions ------------------------------------------------

    def to_ell(self, max_nnz_per_row: int | None = None,
               pad_multiple: int = 8):
        from libhpc_tpu_torch.sparse.ell import ELL

        return ELL.from_csr(self, max_nnz_per_row, pad_multiple=pad_multiple)

    def to_bsr(self, block: int = 8):
        from libhpc_tpu_torch.sparse.bsr import BSR

        return BSR.from_csr(self, block=block)

    # -- ops ---------------------------------------------------------------

    def __matmul__(self, x):
        """csr_spmv for a vector, csr_spmm for a matrix; a numpy x goes to
        this CSR's device."""
        from libhpc_tpu_torch.ops import spmm, spmv

        x = as_tensor(x, self.device)
        if x.ndim == 1:
            return spmv.csr_spmv(self, x)
        return spmm.csr_spmm(self, x)
