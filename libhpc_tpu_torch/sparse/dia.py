"""DIA (diagonal) sparse format of torch tensors.

Port of ``libhpc_tpu/sparse/dia.py:DIA``. For banded matrices (Poisson
stencils, structured FEM) SpMV is a static set of shifted elementwise
multiply-adds: no index arrays, no gather.

Storage follows scipy.sparse.dia_matrix: data[d, j] holds A[j - offset[d], j]
(column-aligned diagonals). Offsets are static fields. ``data`` keeps
scipy's dtype. ``from_scipy`` builds on the host and moves the leaves to
``device`` (default ``"cuda"``) once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.sparse._leaves import (TensorLeaves, tensor_from_numpy,
                                             tensor_to_numpy)


@dataclasses.dataclass(frozen=True)
class DIA(TensorLeaves):
    """data: (ndiags, ncols); offsets/shape static."""

    data: torch.Tensor
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def nnz_stored(self) -> int:
        return self.data.shape[0] * self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @staticmethod
    def from_scipy(sp, device="cuda") -> "DIA":
        """Build on the host, then move the leaves to ``device`` once."""
        d = sp.todia()
        data = np.asarray(d.data)
        ncols = d.shape[1]
        if data.shape[1] < ncols:  # scipy may emit a narrower data array
            data = np.pad(data, ((0, 0), (0, ncols - data.shape[1])))
        return DIA(
            data=tensor_from_numpy(data),
            offsets=tuple(int(o) for o in d.offsets),
            shape=d.shape,
        ).to(device)

    @staticmethod
    def from_csr(csr) -> "DIA":
        """On the device the CSR lies on."""
        return DIA.from_scipy(csr.to_scipy(), device=csr.device)

    def to_pallas(self, T: int = 1 << 17):
        """Tile for the streaming DIA kernel (ops/spmv_dia.py), the
        reference's path once the working set passes its threshold; on
        the device this DIA lies on."""
        from libhpc_tpu_torch.ops.spmv_dia import DiaPallas

        return DiaPallas.from_dia(self, T=T, device=self.device)

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.dia_matrix(
            (tensor_to_numpy(self.data), np.asarray(self.offsets, np.int64)),
            shape=self.shape,
        ).tocsr()

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m, n), dtype=self.data.dtype,
                          device=self.data.device)
        cols = torch.arange(n, device=self.data.device)
        for d, o in enumerate(self.offsets):
            rows = cols - o
            valid = (rows >= 0) & (rows < m)
            out.index_put_((rows[valid], cols[valid]), self.data[d][valid],
                           accumulate=True)
        return out

    def __matmul__(self, x):
        from libhpc_tpu_torch.ops.spmv import dia_spmv

        return dia_spmv(self, x)
