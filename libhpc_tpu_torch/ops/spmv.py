"""Sparse matrix-vector products computed with plain torch ops.

Port of ``libhpc_tpu/ops/spmv.py``, every function of it: ``csr_spmv``,
``ell_spmv``, ``bsr_spmv``, ``bell_spmv``, ``far_spmv``, ``coo_spmv``,
``MAX_DIA_OFFSETS``, ``_guard_dia``, ``dia_spmv``, ``csr_spmv_t``,
``dia_spmv_t`` and ``hybrid_spmv``. The reference computes these in XLA,
not Pallas, so the port computes them with torch ops (gather, index_add,
slice adds, batched products). Where the reference reduces float32 on the
MXU at ``precision="highest"``, the port's float32 products run in full
float32: the port sets no TF32 flag, and PyTorch leaves TF32 off for
matmuls by default.
"""

from __future__ import annotations

import torch


def csr_spmv(csr, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for CSR A. Padding entries (col 0, val 0) contribute 0."""
    prod = csr.data * x[csr.indices.long()]
    out = torch.zeros(csr.shape[0], dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, csr.row_of_nnz().long(), prod)


def ell_spmv(ell, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for ELL A — the regular-row path."""
    return (ell.vals * x[ell.cols.long()]).sum(dim=1)


def bsr_spmv(bsr, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for BSR A: batched b x b block-dots, then a block-row
    segment sum."""
    b = bsr.b
    gx = x.reshape(-1, b)[bsr.indices.long()]              # (nblocks, b)
    prod = torch.bmm(bsr.blocks, gx[:, :, None])[:, :, 0]  # nij,nj->ni
    yb = torch.zeros((bsr.n_block_rows, b), dtype=prod.dtype,
                     device=prod.device)
    yb.index_add_(0, bsr.block_row_of_block().long(), prod)
    return yb.reshape(-1)


def bell_spmv(bell, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for BELL A: one row-gather of x a block and a dense-axis
    contraction over (K, j); padding blocks multiply to zero."""
    nbr, K, b, _ = bell.blocks.shape
    g = x.reshape(-1, b)[bell.indices.long()]              # (nbr, K, b)
    # rkij,rkj->ri: a block-dot a stored block, then a sum over K
    prod = torch.bmm(bell.blocks.reshape(nbr * K, b, b),
                     g.reshape(nbr * K, b, 1))
    return prod.reshape(nbr, K, b).sum(dim=1).reshape(-1)


def far_spmv(far, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a FarBlocks block-COO set (sparse/sbell.py): one x
    row-gather per stored block and a scatter-add over the touched
    block-rows (duplicates allowed). Sums are f32 for bf16 blocks too."""
    b = far.blocks.shape[-1]
    nbr = far.shape[0] // b
    g = x.reshape(-1, b)[far.cols.long()]                   # (nf, b)
    yb = (far.blocks.float() * g[:, None, :]).sum(dim=-1)   # nij,nj->ni
    out = torch.zeros((nbr, b), dtype=torch.float32, device=x.device)
    return out.index_add_(0, far.rows.long(), yb).reshape(-1)


def coo_spmv(coo, x: torch.Tensor) -> torch.Tensor:
    prod = coo.data * x[coo.col.long()]
    out = torch.zeros(coo.shape[0], dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, coo.row.long(), prod)


# the reference unrolls one slice+add pair per diagonal into its program;
# past this many offsets the program blows up. The port keeps the cap so
# the same matrices are refused: they belong to SBELL.
MAX_DIA_OFFSETS = 96


def _guard_dia(dia):
    if len(dia.offsets) > MAX_DIA_OFFSETS:
        raise ValueError(
            f"dia_spmv: {len(dia.offsets)} diagonal offsets exceeds the "
            f"compile-safety cap of {MAX_DIA_OFFSETS}; this matrix is only "
            "quasi-structured — use hybrid_spmv (RCM band + ELL rest) or "
            "the SBELL path (ops/spmv_sbell.py) instead.")


def dia_spmv(dia, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for DIA A — zero-gather shifted multiply-adds.

    Each static diagonal offset o contributes
      y[j - o] += data[d, j] * x[j]   for valid columns j
    in diagonal order, as the reference's pad+add chain does. The adds go
    into slices of y in place (y is a fresh tensor of data's dtype)."""
    _guard_dia(dia)
    m, n = dia.shape
    y = torch.zeros((m,), dtype=dia.data.dtype, device=dia.data.device)
    for d, o in enumerate(dia.offsets):
        # valid columns j: max(0, o) <= j < min(n, m + o)
        j0 = max(0, o)
        j1 = min(n, m + o)
        if j1 <= j0:
            continue
        y[j0 - o:j1 - o] += dia.data[d, j0:j1] * x[j0:j1]
    return y


def csr_spmv_t(csr, y: torch.Tensor) -> torch.Tensor:
    """x = A^T @ y for CSR A (the CSC view): the products scatter over the
    columns."""
    prod = csr.data * y[csr.row_of_nnz().long()]
    out = torch.zeros(csr.shape[1], dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, csr.indices.long(), prod)


def dia_spmv_t(dia, y: torch.Tensor) -> torch.Tensor:
    """x = A^T @ y for DIA A: the same diagonals read the other way. The
    adds go into slices of x in place (x is a fresh tensor of data's
    dtype)."""
    _guard_dia(dia)
    m, n = dia.shape
    x = torch.zeros((n,), dtype=dia.data.dtype, device=dia.data.device)
    for d, o in enumerate(dia.offsets):
        j0 = max(0, o)
        j1 = min(n, m + o)
        if j1 <= j0:
            continue
        x[j0:j1] += dia.data[d, j0:j1] * y[j0 - o:j1 - o]
    return x


def hybrid_spmv(hyb, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for BandedHybrid A: permute, DIA band + ELL remainder,
    unpermute."""
    xp = x[hyb.perm.long()]
    yp = dia_spmv(hyb.band, xp) + ell_spmv(hyb.rest, xp)
    return yp[hyb.iperm.long()]
