"""Banded-hybrid format: RCM reordering + DIA band + sparse remainder.

Port of ``libhpc_tpu/sparse/hybrid.py:BandedHybrid``. The matrix is
reordered with reverse Cuthill-McKee (scipy, on the host) to pull its
nonzeros toward the diagonal; the ``max_diags`` most populated diagonals
are stored as DIA (no gather) and the rest as ELL. SpMV = dia_spmv +
ell_spmv on the permuted vector (``ops/spmv.py:hybrid_spmv``).
``coverage`` is the fraction of nonzeros the band captures. The builder
is the reference's numpy/scipy code, so ``perm``/``iperm`` and both parts
equal the reference's; the leaves move to ``device`` (default ``"cuda"``)
once at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.ops._cuda_utils import as_tensor
from libhpc_tpu_torch.sparse._leaves import TensorLeaves, tensor_from_numpy
from libhpc_tpu_torch.sparse.dia import DIA
from libhpc_tpu_torch.sparse.ell import ELL


@dataclasses.dataclass(frozen=True)
class BandedHybrid(TensorLeaves):
    """A = P^T (band + rest) P with permutation P (RCM or identity).

    perm: int32 (n,), the row/column permutation applied to the matrix
    (A_perm = A[perm][:, perm]); spmv computes in permuted space and maps
    back, so callers see original-order vectors.
    """

    band: DIA
    rest: ELL
    perm: torch.Tensor
    iperm: torch.Tensor
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    coverage: float = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def from_scipy(sp, max_diags: int = 32, rcm: bool = True,
                   pad_multiple: int = 8, device="cuda") -> "BandedHybrid":
        import scipy.sparse as sps
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        sp = sps.csr_matrix(sp)
        n = sp.shape[0]
        if sp.shape[0] != sp.shape[1]:
            raise ValueError("hybrid format assumes a square matrix")
        if rcm:
            perm = np.asarray(
                reverse_cuthill_mckee(sp, symmetric_mode=False), np.int32
            )
        else:
            perm = np.arange(n, dtype=np.int32)
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(n, dtype=np.int32)
        A = sp[perm][:, perm].tocoo()

        # diagonal population census
        offs = A.col.astype(np.int64) - A.row.astype(np.int64)
        uniq, counts = np.unique(offs, return_counts=True)
        order = np.argsort(-counts)
        band_offs = uniq[order[:max_diags]]
        in_band = np.isin(offs, band_offs)
        coverage = float(in_band.sum()) / max(len(offs), 1)

        band_coo = sps.coo_matrix(
            (A.data[in_band], (A.row[in_band], A.col[in_band])), shape=A.shape
        )
        rest_coo = sps.coo_matrix(
            (A.data[~in_band], (A.row[~in_band], A.col[~in_band])),
            shape=A.shape,
        )
        band = DIA.from_scipy(band_coo, device="cpu")
        rest = ELL.from_scipy(rest_coo.tocsr(), pad_multiple=pad_multiple,
                              device="cpu")
        return BandedHybrid(
            band=band, rest=rest,
            perm=tensor_from_numpy(perm), iperm=tensor_from_numpy(iperm),
            shape=tuple(sp.shape), coverage=coverage,
        ).to(device)

    def __matmul__(self, x):
        from libhpc_tpu_torch.ops.spmv import hybrid_spmv

        return hybrid_spmv(self, as_tensor(x, self.device))
