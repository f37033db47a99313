"""COO (coordinate) sparse matrix of torch tensors.

Port of ``libhpc_tpu/sparse/coo.py:COO``: the entry of the container
stack. Triplets are sorted into canonical (row-major, column-major or
Morton) order and segmented into CSR, a sort-then-segment flow in place of
libHPC's insert-on-touch grid build (lib/sparse/include/HashBlock.hpp:
92-102). The reference computes in plain ``jnp`` (``lax.sort``,
``segment_sum``), so the port computes with torch ops: a stable sort on
one int64 key, ``index_add_`` and scatters. The builders build on the
host and move the leaves to ``device`` (default ``"cuda"``) once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.sparse._leaves import (TensorLeaves, tensor_from_numpy,
                                             tensor_to_numpy)


@dataclasses.dataclass(frozen=True)
class COO(TensorLeaves):
    """Coordinate-format sparse matrix.

    ``row``/``col`` are int32 tensors of shape (nnz,), ``data`` any dtype
    of shape (nnz,). ``shape`` is static. Duplicate coordinates are
    allowed until :meth:`sum_duplicates` is called.
    """

    row: torch.Tensor
    col: torch.Tensor
    data: torch.Tensor
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_dense(mat, device="cuda") -> "COO":
        mat = np.asarray(mat)
        r, c = np.nonzero(mat)
        return COO(
            row=tensor_from_numpy(r.astype(np.int32)),
            col=tensor_from_numpy(c.astype(np.int32)),
            data=tensor_from_numpy(mat[r, c]),
            shape=tuple(mat.shape),
        ).to(device)

    @staticmethod
    def from_scipy(sp, device="cuda") -> "COO":
        sp = sp.tocoo()
        return COO(
            row=tensor_from_numpy(sp.row.astype(np.int32)),
            col=tensor_from_numpy(sp.col.astype(np.int32)),
            data=tensor_from_numpy(sp.data),
            shape=tuple(sp.shape),
        ).to(device)

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.coo_matrix(
            (tensor_to_numpy(self.data), (tensor_to_numpy(self.row),
                                          tensor_to_numpy(self.col))),
            shape=self.shape)

    # -- ops ---------------------------------------------------------------

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.data.device)
        return out.index_put_((self.row.long(), self.col.long()), self.data,
                              accumulate=True)

    def _order(self, order: str) -> torch.Tensor:
        """Stable permutation into `order`, by one int64 key."""
        if order == "row":
            key = self.row.long() * self.shape[1] + self.col.long()
        elif order == "col":
            key = self.col.long() * self.shape[0] + self.row.long()
        elif order == "morton":
            from libhpc_tpu_torch.utils.morton import morton2d_encode

            code = morton2d_encode(self.col, self.row)
            key = code.view(torch.int32).long() & 0xFFFFFFFF
        else:
            raise ValueError(f"unknown order {order!r}")
        return torch.sort(key, stable=True).indices

    def sort_indices(self, order: str = "row") -> "COO":
        """Sort triplets into canonical order.

        order: 'row' (row-major CSR order), 'col', or 'morton' (Z-order of
        (col, row), the locality layout replacing libmorton tiling)."""
        perm = self._order(order)
        return COO(row=self.row[perm], col=self.col[perm],
                   data=self.data[perm], shape=self.shape)

    def sum_duplicates(self) -> "COO":
        """Combine duplicate coordinates (sorted row-major output).

        The output keeps nnz slots: duplicates collapse into the first
        occurrence and freed slots at the end become zero-data entries at
        (0, 0), which every additive op treats as no-ops."""
        n = self.nnz
        if n == 0:
            return self
        c = self.sort_indices("row")
        is_head = torch.ones(n, dtype=torch.bool, device=c.row.device)
        is_head[1:] = (c.row[1:] != c.row[:-1]) | (c.col[1:] != c.col[:-1])
        seg = torch.cumsum(is_head, 0) - 1
        data = torch.zeros(n, dtype=c.data.dtype,
                           device=c.data.device).index_add_(0, seg, c.data)
        # every entry of a segment has the same coordinates
        row = torch.zeros_like(c.row).scatter_(0, seg, c.row)
        col = torch.zeros_like(c.col).scatter_(0, seg, c.col)
        return COO(row=row, col=col, data=data, shape=self.shape)

    def tocsr(self):
        from libhpc_tpu_torch.sparse.csr import CSR

        return CSR.from_coo(self)
