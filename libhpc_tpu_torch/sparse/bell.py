"""BELL (block-ELLPACK) of torch tensors.

Port of ``libhpc_tpu/sparse/bell.py:BELL``: BSR with each block-row padded
to a fixed K blocks, so the SpMV reduces along a dense axis instead of a
segment scatter-add. Padding blocks are zero with column index 0: they
multiply to zero. The host builder is the reference's numpy code; the
leaves move to ``device`` (default ``"cuda"``) once at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.ops._cuda_utils import as_tensor
from libhpc_tpu_torch.sparse._leaves import TensorLeaves, tensor_from_numpy


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class BELL(TensorLeaves):
    """Block-ELL matrix.

    blocks:  (n_block_rows, K, b, b) dense tiles (zero-padded)
    indices: int32 (n_block_rows, K) block-column ids (0 where padded)
    shape:   element-level (nrows, ncols), multiples of b
    """

    blocks: torch.Tensor
    indices: torch.Tensor
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def b(self) -> int:
        return self.blocks.shape[2]

    @property
    def K(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_block_rows(self) -> int:
        return self.blocks.shape[0]

    @property
    def nnz_stored(self) -> int:
        return int(np.prod(self.blocks.shape))

    @property
    def dtype(self):
        return self.blocks.dtype

    @staticmethod
    def from_bsr(bsr) -> "BELL":
        """Host-side conversion from BSR, on the device the BSR lies on."""
        indptr = _np(bsr.indptr)
        indices = _np(bsr.indices)
        blocks = _np(bsr.blocks)
        nbr = len(indptr) - 1
        counts = np.diff(indptr)
        K = max(1, int(counts.max()))
        b = bsr.b
        out_blocks = np.zeros((nbr, K, b, b), blocks.dtype)
        out_idx = np.zeros((nbr, K), np.int32)
        for r in range(nbr):
            c = counts[r]
            out_blocks[r, :c] = blocks[indptr[r]:indptr[r + 1]]
            out_idx[r, :c] = indices[indptr[r]:indptr[r + 1]]
        return BELL(blocks=tensor_from_numpy(out_blocks),
                    indices=tensor_from_numpy(out_idx),
                    shape=bsr.shape).to(bsr.device)

    @staticmethod
    def from_scipy(sp, block: int = 8, device="cuda") -> "BELL":
        from libhpc_tpu_torch.sparse.bsr import BSR

        return BELL.from_bsr(BSR.from_scipy(sp, block=block,
                                            device="cpu")).to(device)

    def fill_ratio(self) -> float:
        true_nnz = int((self.blocks != 0).sum())
        return self.nnz_stored / max(true_nnz, 1)

    def todense(self) -> torch.Tensor:
        nbr, K, b, _ = self.blocks.shape
        nbc = self.shape[1] // b
        out = torch.zeros((nbr, nbc, b, b), dtype=self.blocks.dtype,
                          device=self.blocks.device)
        r = torch.arange(nbr, device=self.blocks.device).repeat_interleave(K)
        c = self.indices.reshape(-1).long()
        out.index_put_((r, c), self.blocks.reshape(nbr * K, b, b),
                       accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(self.shape)

    def __matmul__(self, x):
        from libhpc_tpu_torch.ops import spmv

        return spmv.bell_spmv(self, as_tensor(x, self.device))
