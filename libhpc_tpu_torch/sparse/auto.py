"""Automatic format selection — one entry point for "just give me a fast
matvec".

Port of ``libhpc_tpu/sparse/auto.py:auto_format``, routing included: the
same scipy matrix gets the same container class with the same fields.

  * few distinct diagonals, each well filled -> DIA with the plain
    ``dia_spmv`` while the working set is at most ``_DIA_VMEM_BYTES``,
    the streaming ``DiaPallas`` kernel past it;
  * scalar-regular (no 8x8 block density) -> SELL-P when its (pane,
    sublane) buckets pack tightly, else the window SELL when every slice
    fits its pane window;
  * everything else -> SBELL (optionally bf16 values).

The thresholds (``_DIA_VMEM_BYTES``, ``_DIA_MAX_OFFSETS``, the fill limits)
were measured on the reference's TPU; H100 thresholds wait for the port's
bench numbers. The container is built on the host and comes back on
``device`` (default ``"cuda"``); ``device="cpu"`` keeps it on the CPU.
"""

from __future__ import annotations

import numpy as np

# past this working set the reference's XLA DIA forms left VMEM and its
# streaming kernel took over (measured on the TPU)
_DIA_VMEM_BYTES = 100 * 1024 * 1024
_DIA_MAX_OFFSETS = 96          # matches ops/spmv.py MAX_DIA_OFFSETS


def auto_format(A, prefer_bf16: bool = False, device="cuda"):
    """Pick a container + matvec for a scipy sparse matrix.

    Returns (container, matvec) where matvec(container, x) -> y and the
    container is one of DIA / DiaPallas / SELLP / SELL / SELLSplit /
    SBELL."""
    import scipy.sparse as sps

    A = sps.csr_matrix(A)
    m, n = A.shape

    # --- structured? count distinct diagonals, and require each stored
    # diagonal to be about quarter-populated before paying for the m*D
    # rectangle
    coo = A.tocoo()
    diags = np.unique(coo.col.astype(np.int64) - coo.row)
    dia_fill_ok = A.nnz >= 0.25 * diags.size * min(m, n)
    if diags.size <= _DIA_MAX_OFFSETS and dia_fill_ok:
        from libhpc_tpu_torch.sparse.dia import DIA

        dia = DIA.from_scipy(A, device="cpu")
        work = dia.data.numel() * 4 + (m + n) * 4
        if work <= _DIA_VMEM_BYTES:
            from libhpc_tpu_torch.ops.spmv import dia_spmv

            return dia.to(device), dia_spmv
        from libhpc_tpu_torch.ops.spmv_dia import DiaPallas, dia_spmv_pallas

        return DiaPallas.from_dia(dia, device=device), dia_spmv_pallas

    # --- 8x8-block-dense (FEM-class)? SBELL. Block fill is estimated from
    # coordinates (unique touched 8x8 blocks), never by densifying to BSR
    n_blocks = np.unique((coo.row.astype(np.int64) >> 3) * (-(-n // 8))
                         + (coo.col.astype(np.int64) >> 3)).size
    blockish = A.nnz >= 0.5 * 64 * max(n_blocks, 1)

    # --- scalar-regular? SELL-P (no window restriction) -----------------
    if not blockish:
        # one row unit per distinct (stripe, x-pane, x-sublane,
        # out-sublane): a lower bound on tiles*8, so a lower bound on
        # fill; reject without paying the builder
        r64 = coo.row.astype(np.int64)
        c64 = coo.col.astype(np.int64)
        unit_key = ((((r64 >> 10) * (-(-n // 1024)) + (c64 >> 10)) << 6)
                    | ((c64 & 7) << 3) | (r64 & 7))
        n_units = np.unique(unit_key).size
        est_fill = n_units * 128 / max(A.nnz, 1)
        if est_fill <= 4.0:
            from libhpc_tpu_torch.ops.sellp import sellp_from_scipy, sellp_spmv

            sp = sellp_from_scipy(A, device="cpu")
            if sp.fill_ratio(A.nnz) <= 4.0:
                return sp.to(device), sellp_spmv
        # SELL-P fragments when entries don't align on (pane, sublane)
        # buckets; the window SELL packs those densely
        from libhpc_tpu_torch.ops import spmv_sell

        lens = np.diff(A.indptr)
        k = int(lens.max()) if lens.size else 0
        if k and k * m <= 4 * max(A.nnz, 1):
            try:
                sell = spmv_sell.sell_from_scipy(A, device=device)
            except ValueError:
                pass    # windows too wide -> SBELL
            else:
                return sell, spmv_sell.sell_spmv

    # --- the unstructured path ------------------------------------------
    from libhpc_tpu_torch.ops.spmv_sbell import sbell_spmv
    from libhpc_tpu_torch.sparse.sbell import SBELL

    sb = SBELL.from_scipy(A, device="cpu")
    if prefer_bf16:
        import torch

        sb = sb.astype_values(torch.bfloat16)
    return sb.to(device), sbell_spmv
