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

Result dtypes follow the reference's. ``ell_spmv`` sums as ``jnp.sum``
does: integers narrower than 32 bits sum into int32 (unsigned ones into
uint32), wrapping. The block products (``bsr_spmv``, ``bell_spmv``, and
``ell_spmm`` / ``bsr_spmm`` in ops/spmm.py) contract as ``einsum(...,
preferred_element_type=<the operator's dtype>)`` does: the right-hand side
is converted to the operator's dtype (a float to an integer saturates) and
the product is computed in it; integer products wrap. torch has no integer
``bmm`` on the card and no uint32 arithmetic anywhere, so integer products
are elementwise products summed in int64 and wrapped into their dtype at
the end, on every device. The DIA products promote as ``jnp`` does.
"""

from __future__ import annotations

import torch

_INT_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32,
             torch.uint8: 8, torch.uint16: 16, torch.uint32: 32}
_SIGNED = (torch.int8, torch.int16, torch.int32)


def _wrap(s: torch.Tensor, dtype) -> torch.Tensor:
    """An int64 tensor reduced modulo 2^bits into the integer `dtype`
    (the wraparound of the reference's fixed-width arithmetic)."""
    if dtype not in _INT_BITS:
        return s.to(dtype)
    bits = _INT_BITS[dtype]
    if dtype in _SIGNED:
        half = 1 << (bits - 1)
        return (((s + half) & ((1 << bits) - 1)) - half).to(dtype)
    return (s & ((1 << bits) - 1)).to(dtype)


def _sum_dtype(dtype):
    """``jnp.sum``'s result dtype without x64: int32 for the narrower
    signed integers and bool, uint32 for the narrower unsigned ones."""
    if dtype in (torch.bool, torch.int8, torch.int16):
        return torch.int32
    if dtype in (torch.uint8, torch.uint16):
        return torch.uint32
    return dtype


def _like_operator(x: torch.Tensor, dtype) -> torch.Tensor:
    """x converted to the operator's dtype, as einsum's
    preferred_element_type converts it: a float into an integer dtype
    truncates and saturates at the dtype's range."""
    if x.dtype == dtype:
        return x
    if x.is_floating_point() and dtype in _INT_BITS:
        info = torch.iinfo(dtype)
        x = x.clamp(info.min, info.max)
    return x.to(dtype)


def _block_dot(blocks: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(n, b, b) x (n, b, c) -> (n, b, c) in the blocks' dtype; integer
    (and bool) blocks in int64, wrapped by the caller."""
    if blocks.is_floating_point():
        return torch.bmm(blocks, g)
    return (blocks.long()[:, :, :, None] * g.long()[:, None, :, :]
            ).sum(dim=2)


def csr_spmv(csr, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for CSR A. Padding entries (col 0, val 0) contribute 0."""
    prod = csr.data * x[csr.indices.long()]
    out = torch.zeros(csr.shape[0], dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, csr.row_of_nnz().long(), prod)


def ell_spmv(ell, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for ELL A — the regular-row path. The products promote
    as torch (and jnp) promote; the sum takes ``jnp.sum``'s dtype."""
    prod = ell.vals * x[ell.cols.long()]
    if prod.dtype in _INT_BITS or prod.dtype == torch.bool:
        return _wrap(prod.sum(dim=1, dtype=torch.int64),
                     _sum_dtype(prod.dtype))
    return prod.sum(dim=1)


def bsr_spmv(bsr, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for BSR A: batched b x b block-dots, then a block-row
    segment sum, in the blocks' dtype."""
    b = bsr.b
    dt = bsr.blocks.dtype
    gx = _like_operator(x, dt).reshape(-1, b)[bsr.indices.long()]
    prod = _block_dot(bsr.blocks, gx[:, :, None])[:, :, 0]  # nij,nj->ni
    # blocks past indptr[-1] add into an extra block row, cut off (the
    # reference's segment_sum drops them)
    yb = torch.zeros((bsr.n_block_rows + 1, b), dtype=prod.dtype,
                     device=prod.device)
    yb.index_add_(0, bsr.block_row_of_block().long(), prod)
    return _wrap(yb[:-1].reshape(-1), dt)


def bell_spmv(bell, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for BELL A: one row-gather of x a block and a dense-axis
    contraction over (K, j), in the blocks' dtype; padding blocks multiply
    to zero."""
    nbr, K, b, _ = bell.blocks.shape
    dt = bell.blocks.dtype
    g = _like_operator(x, dt).reshape(-1, b)[bell.indices.long()]
    # rkij,rkj->ri: a block-dot a stored block, then a sum over K
    prod = _block_dot(bell.blocks.reshape(nbr * K, b, b),
                      g.reshape(nbr * K, b, 1))
    return _wrap(prod.reshape(nbr, K, b).sum(dim=1).reshape(-1), dt)


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


def _dia_dtype(dia, x: torch.Tensor):
    """The dtype of a DIA product: data's own when no diagonal meets the
    matrix (the reference then returns its zeros), else data's promoted
    with x's."""
    m, n = dia.shape
    if any(min(n, m + o) > max(0, o) for o in dia.offsets):
        return torch.promote_types(dia.data.dtype, x.dtype)
    return dia.data.dtype


def dia_spmv(dia, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for DIA A — zero-gather shifted multiply-adds.

    Each static diagonal offset o contributes
      y[j - o] += data[d, j] * x[j]   for valid columns j
    in diagonal order, as the reference's pad+add chain does. The adds go
    into slices of y in place; y takes the dtype of data * x, as the
    reference's sum of data-dtype zeros and the products does."""
    _guard_dia(dia)
    m, n = dia.shape
    y = torch.zeros((m,), dtype=_dia_dtype(dia, x), device=dia.data.device)
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
    adds go into slices of x in place (x takes dia_spmv's dtype)."""
    _guard_dia(dia)
    m, n = dia.shape
    x = torch.zeros((n,), dtype=_dia_dtype(dia, y), device=dia.data.device)
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
    band, rest = dia_spmv(hyb.band, xp), ell_spmv(hyb.rest, xp)
    if torch.uint32 in (band.dtype, rest.dtype):   # no uint32 add in torch
        return _wrap((band.long() + rest.long())[hyb.iperm.long()],
                     torch.uint32)
    return (band + rest)[hyb.iperm.long()]
