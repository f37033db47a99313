"""Sparse x dense (tall-skinny) matrix products: SpMM.

Port of ``libhpc_tpu/ops/spmm.py`` (``csr_spmm``, ``ell_spmm``,
``bsr_spmm``): sparse A times a dense B of ~64 columns, where each
gathered row of B is a dense tile and the reduction amortizes the index
traffic over the columns. The reference computes these in XLA, not
Pallas, so the port computes them with torch ops (gather, batched
products, ``index_add_``). Its float32 products run in full float32, as
the reference's ``precision="highest"`` asks: the port sets no TF32 flag.
``ell_spmm`` and ``bsr_spmm`` return the operator's dtype, as the
reference's ``preferred_element_type`` does (ops/spmv.py says how).
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.ops.spmv import _block_dot, _like_operator, _wrap


def csr_spmm(csr, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B, A CSR (m x n), B dense (n, c)."""
    prod = csr.data[:, None] * B[csr.indices.long()]      # (nnz, c)
    out = torch.zeros((csr.shape[0], B.shape[1]), dtype=prod.dtype,
                      device=prod.device)
    return out.index_add_(0, csr.row_of_nnz().long(), prod)


def ell_spmm(ell, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B, A ELL (m x n) with k slots a row, B dense (n, c): B
    gathered into an (m, k, c) brick, k contracted by a batched product."""
    dt = ell.vals.dtype
    gB = _like_operator(B, dt)[ell.cols.long()]           # (m, k, c)
    prod = _block_dot(ell.vals[:, None, :], gB)[:, 0, :]  # mk,mkc->mc
    return _wrap(prod, dt)


def bsr_spmm(bsr, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B, A BSR (m x n) with b x b blocks, B dense (n, c): a
    batched (b, b) x (b, c) product a block, then a block-row segment
    sum."""
    b = bsr.b
    c = B.shape[1]
    dt = bsr.blocks.dtype
    gB = _like_operator(B, dt).reshape(-1, b, c)[bsr.indices.long()]
    prod = _block_dot(bsr.blocks, gB)                     # nij,njc->nic
    Yb = torch.zeros((bsr.n_block_rows + 1, b, c), dtype=prod.dtype,
                     device=prod.device)       # + 1: as in bsr_spmv
    Yb.index_add_(0, bsr.block_row_of_block().long(), prod)
    return _wrap(Yb[:-1].reshape(bsr.shape[0], c), dt)
