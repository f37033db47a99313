"""BSR (block sparse row) of torch tensors.

Port of ``libhpc_tpu/sparse/bsr.py:BSR``: dense ``b x b`` tiles addressed
by a block-level CSR structure, optionally with the blocks of each
block-row in Morton order (the descendant of libHPC's hierarchical
DenseBlock leaves, lib/sparse/include/DenseBlock.hpp:12-13, and its
libmorton tilings). Block values are one (nblocks, b, b) tensor, so the
SpMV and SpMM are batched b x b products. The host builder is the
reference's scipy code; the leaves move to ``device`` (default ``"cuda"``)
once at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.ops._cuda_utils import as_tensor
from libhpc_tpu_torch.sparse._leaves import TensorLeaves, tensor_from_numpy


@dataclasses.dataclass(frozen=True)
class BSR(TensorLeaves):
    """Block-CSR matrix.

    blocks:  (nblocks, b, b) dense tiles
    indices: int32 (nblocks,) block-column index of each tile
    indptr:  int32 (n_block_rows + 1,)
    shape:   element-level (nrows, ncols); multiples of b
    """

    blocks: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def b(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_block_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nblocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def nnz_stored(self) -> int:
        """Stored element count including intra-block zero fill-in."""
        return self.nblocks * self.b * self.b

    @property
    def dtype(self):
        return self.blocks.dtype

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_scipy(sp, block: int = 8, morton: bool = False,
                   device="cuda") -> "BSR":
        """Host-side conversion via scipy's BSR; shapes pad up to
        multiples of ``block``."""
        import scipy.sparse as sps

        nr, nc = sp.shape
        b = block
        nr_pad = -(-nr // b) * b
        nc_pad = -(-nc // b) * b
        if (nr_pad, nc_pad) != (nr, nc):
            sp = sps.csr_matrix(
                (sp.tocsr().data, sp.tocsr().indices, sp.tocsr().indptr),
                shape=(nr, nc),
            )
            sp = sps.vstack(
                [sp, sps.csr_matrix((nr_pad - nr, nc), dtype=sp.dtype)]
            )
            sp = sps.hstack(
                [sp, sps.csr_matrix((nr_pad, nc_pad - nc), dtype=sp.dtype)]
            ).tocsr()
        bsr = sp.tobsr(blocksize=(b, b))
        bsr.sort_indices()
        blocks = np.asarray(bsr.data)
        indices = bsr.indices.astype(np.int32)
        indptr = bsr.indptr.astype(np.int32)
        if morton:
            blocks, indices, indptr = _morton_reorder(blocks, indices,
                                                      indptr)
        return BSR(blocks=tensor_from_numpy(blocks),
                   indices=tensor_from_numpy(indices),
                   indptr=tensor_from_numpy(indptr),
                   shape=(nr_pad, nc_pad)).to(device)

    @staticmethod
    def from_csr(csr, block: int = 8, morton: bool = False) -> "BSR":
        """On the device the CSR lies on."""
        return BSR.from_scipy(csr.to_scipy(), block=block, morton=morton,
                              device=csr.device)

    @staticmethod
    def from_dense(mat, block: int = 8, device="cuda") -> "BSR":
        import scipy.sparse as sps

        return BSR.from_scipy(sps.csr_matrix(np.asarray(mat)), block=block,
                              device=device)

    # -- derived -----------------------------------------------------------

    def block_row_of_block(self) -> torch.Tensor:
        pos = torch.arange(self.nblocks, dtype=torch.int32,
                           device=self.indptr.device)
        return (torch.searchsorted(self.indptr, pos, right=True)
                .to(torch.int32) - 1)

    def todense(self) -> torch.Tensor:
        """Blocks past indptr[-1] (the one zero block of an empty SpGEMM
        product) land in an extra block row that is cut off, as the
        reference's scatter drops them."""
        b = self.b
        nbr = self.n_block_rows
        nbc = self.shape[1] // b
        out = torch.zeros((nbr + 1, nbc, b, b), dtype=self.blocks.dtype,
                          device=self.blocks.device)
        out.index_put_((self.block_row_of_block().long(),
                        self.indices.long()), self.blocks, accumulate=True)
        return out[:nbr].permute(0, 2, 1, 3).reshape(self.shape)

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.csr_matrix(self.todense().cpu().numpy())

    def fill_ratio(self) -> float:
        """Stored elements / true nonzeros: the BSR fill-in overhead."""
        true_nnz = int((self.blocks != 0).sum())
        return self.nnz_stored / max(true_nnz, 1)

    def __matmul__(self, x):
        from libhpc_tpu_torch.ops import spmv

        return spmv.bsr_spmv(self, as_tensor(x, self.device))


def _morton_reorder(blocks, indices, indptr):
    """Reorder blocks within each block-row by the Morton code of (bcol,
    brow), host-side in numpy (a one-time setup transform); a stable sort
    by (brow, code) keeps the CSR structure valid."""
    from libhpc_tpu_torch.utils.morton import morton2d_encode

    brow = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    code = morton2d_encode(indices.astype(np.uint32),
                           brow.astype(np.uint32), device="cpu")
    code = code.view(torch.int32).numpy().view(np.uint32)
    order = np.lexsort((code, brow))
    return blocks[order], indices[order].astype(np.int32), indptr
