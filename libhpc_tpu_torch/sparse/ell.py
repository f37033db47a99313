"""ELL (ELLPACK) sparse format of torch tensors.

Port of ``libhpc_tpu/sparse/ell.py:ELL``. Each row stores exactly
``k = max_nnz_per_row`` (column, value) slots, padded with (0, 0.0): the
dense (nrows, k) rectangle that SELL (ops/spmv_sell.py) is built from. The
host builder is the reference's numpy code line for line.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.sparse._leaves import TensorLeaves, tensor_from_numpy


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass(frozen=True)
class ELL(TensorLeaves):
    """cols: int32 (nrows, k); vals: (nrows, k); padded slots are (0, 0)."""

    vals: torch.Tensor
    cols: torch.Tensor
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def dtype(self):
        return self.vals.dtype

    @staticmethod
    def from_csr(csr, max_nnz_per_row: int | None = None,
                 pad_multiple: int = 8) -> "ELL":
        """Pack CSR into ELL on the host in numpy, on the device the CSR
        lies on. k is rounded up to ``pad_multiple``."""
        indptr = _np(csr.indptr)
        indices = _np(csr.indices)
        data = _np(csr.data)
        lengths = np.diff(indptr)
        actual_max = int(lengths.max()) if lengths.size else 0
        if max_nnz_per_row is None:
            max_nnz_per_row = actual_max
        elif max_nnz_per_row < actual_max:
            raise ValueError(
                f"max_nnz_per_row={max_nnz_per_row} < actual max row length "
                f"{actual_max}; entries would be dropped"
            )
        k = max(1, -(-max_nnz_per_row // pad_multiple) * pad_multiple)
        nrows = csr.shape[0]
        if len(indices) == 0:  # empty matrix: all-padding ELL
            return ELL(
                vals=tensor_from_numpy(np.zeros((nrows, k), data.dtype)),
                cols=tensor_from_numpy(np.zeros((nrows, k), np.int32)),
                shape=csr.shape,
            ).to(csr.device)
        slot = np.arange(k, dtype=np.int64)[None, :]
        src = indptr[:-1, None].astype(np.int64) + slot
        valid = slot < lengths[:, None]
        src = np.where(valid, src, 0)
        cols = np.where(valid, indices[src], 0).astype(np.int32)
        vals = np.where(valid, data[src], 0).astype(data.dtype)
        return ELL(vals=tensor_from_numpy(vals), cols=tensor_from_numpy(cols),
                   shape=csr.shape).to(csr.device)

    @staticmethod
    def from_scipy(sp, pad_multiple: int = 8, device="cuda") -> "ELL":
        """Build on the host, then move the leaves to ``device`` once."""
        from libhpc_tpu_torch.sparse.csr import CSR

        return ELL.from_csr(CSR.from_scipy(sp, device="cpu"),
                            pad_multiple=pad_multiple).to(device)

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.vals.device)
        rows = torch.arange(self.shape[0], device=self.cols.device)[:, None]
        return out.index_put_((rows.expand_as(self.cols), self.cols.long()),
                              self.vals, accumulate=True)

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.csr_matrix(self.todense().cpu().numpy())
