"""Block SpGEMM: C = A @ B on b x b blocks (8 x 8 for the FEM matrices).

Port of ``libhpc_tpu/ops/spgemm_bsr.py``. On the block level

    C[i,j] += A[i,k] @ B[k,j]          (b x b times b x b block products)

so the structure pass shrinks b^2-fold (symbolic on block indices) and the
numeric pass is batched dense block products and one segment sum: no sort,
no per-scalar gathers. The same two-pass skeleton as libHPC's count ->
scan -> scatter (radix_sort_cpu.hpp:254-322):

  symbolic (host numpy, line for line the reference's): pair every A block
     (i, k) with every B block (k, j), sort the pairs by output block
     (i, j) and give each output block a contiguous segment id;
  numeric (the operands' device): gather the paired blocks, b x b products
     in float32, ``index_add_`` of the products into C's blocks.

The reference builds each block product from 2 b one-hot lane-permutation
matmuls, a workaround for the TPU's layout; the port computes the same
blocks directly: ``mxu=True`` a batched ``torch.bmm`` in full float32 (the
port sets no TF32 flag), ``mxu=False`` the b elementwise products added in
the order j = 0 .. b-1, the reference's own order of adds. Block values are
cast to float32 before the products (integer blocks never reach ``bmm``)
and C's blocks are cast back to A's dtype. On the card ``index_add_`` adds
with atomics, so the last bits of a block summed from several pairs may
vary from run to run.

Memory: the numeric pass is chunked over pairs (PAIR_CHUNK), so device
memory stays O(chunk + nnzb_C) at any expansion size; chunk boundaries need
not respect segments because partial segment sums add.

Where the port differs: the reference keeps C's blocks as a host numpy
leaf (a workaround for a TPU compiler crash); the port returns them as a
tensor on the operands' device, so a follow-up ``C @ x`` runs there.
"""

from __future__ import annotations

import numpy as np
import torch

from libhpc_tpu_torch.sparse.bsr import BSR

PAIR_CHUNK = 1 << 22          # pairs per numeric pass (~0.8 GB of blocks)


def _symbolic(ai, ap, bi, bp, nbc_out):
    """Host pair enumeration: returns (ia, ib, seg, out_rows, out_cols).

    ia/ib index A.blocks/B.blocks per partial product, ordered so seg
    (the output-block id of each pair) is non-decreasing; out_rows/cols
    give each output block's (block-row, block-col), sorted row-major.
    """
    nbr_a = ap.size - 1
    # A entries sorted by block-column k (CSC-of-blocks view)
    a_rows = np.repeat(np.arange(nbr_a, dtype=np.int64), np.diff(ap))
    order_k = np.argsort(ai, kind="stable")
    a_sorted = order_k.astype(np.int64)          # A block idx by k
    a_row_s = a_rows[order_k]
    k_sorted = ai[order_k].astype(np.int64)
    # per-k counts in A (by column) and B (by row)
    nk = bp.size - 1
    nA_k = np.bincount(k_sorted, minlength=nk)
    nB_k = (bp[1:] - bp[:-1]).astype(np.int64)
    a_start = np.concatenate([[0], np.cumsum(nA_k)])
    P_k = nA_k * nB_k
    offs = np.concatenate([[0], np.cumsum(P_k)])
    P = int(offs[-1])
    if P == 0:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.int64),
                                               np.zeros(0, np.int64),
                                               np.zeros(0, np.int64))
    # expand: group g = k value with P_k>0; pair p in group g has
    # local q = p - offs[g]; a_local = q // nB_k, b_local = q % nB_k
    live = np.flatnonzero(P_k)
    grp = np.repeat(live, P_k[live])
    q = np.arange(P, dtype=np.int64) - offs[grp]
    a_loc = q // nB_k[grp]
    b_loc = q - a_loc * nB_k[grp]
    ia = a_sorted[a_start[grp] + a_loc]
    ib = bp[grp] + b_loc
    out_r = a_row_s[a_start[grp] + a_loc]
    out_c = bi[ib].astype(np.int64)
    key = out_r * np.int64(nbc_out) + out_c
    order = np.argsort(key, kind="stable")
    ia, ib, key = ia[order], ib[order], key[order]
    uniq, seg = np.unique(key, return_inverse=True)
    return ia, ib, seg, uniq // nbc_out, uniq % nbc_out


def _numeric_chunk(Ab, Bb, ia, ib, seg, acc, n_out: int, mxu: bool,
                   bsz: int = 8):
    """One pair chunk: gather, b x b block products, segment sum into acc
    ((n_out, b, b) float32, updated in place and returned). Ab and Bb are
    the blocks in float32; ia, ib, seg int64 tensors of the chunk."""
    a = Ab[ia]                                  # (P, b, b)
    b = Bb[ib]
    if mxu:
        prod = torch.bmm(a, b)
    else:
        prod = a[:, :, 0, None] * b[:, None, 0, :]
        for j in range(1, bsz):
            prod = prod + a[:, :, j, None] * b[:, None, j, :]
    return acc.index_add_(0, seg, prod)


def spgemm_bsr(A: BSR, B: BSR, mxu: bool = True,
               pair_chunk: int = PAIR_CHUNK) -> BSR:
    """C = A @ B for BSR matrices with equal block size.

    Host symbolic pass (numpy, setup-class like every container build),
    numeric pass on the operands' device (gather + batched block products
    + segment sum), chunked over pairs. Returns BSR with row-major sorted
    blocks on that device.
    """
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"shape mismatch {A.shape} @ {B.shape}")
    if A.b != B.b:
        raise ValueError(f"block size mismatch {A.b} vs {B.b}")
    bsz = A.b
    dev = A.device
    nbc_out = B.shape[1] // bsz
    ai = A.indices.cpu().numpy().astype(np.int64)
    ap = A.indptr.cpu().numpy().astype(np.int64)
    bi = B.indices.cpu().numpy().astype(np.int64)
    bp = B.indptr.cpu().numpy().astype(np.int64)
    ia, ib, seg, out_r, out_c = _symbolic(ai, ap, bi, bp, nbc_out)
    n_out = max(int(out_r.size), 1)
    P = ia.size
    if P == 0:
        z = torch.zeros((1, bsz, bsz), dtype=A.blocks.dtype, device=dev)
        return BSR(blocks=z,
                   indices=torch.zeros((1,), dtype=torch.int32, device=dev),
                   indptr=torch.zeros((A.shape[0] // bsz + 1,),
                                      dtype=torch.int32, device=dev),
                   shape=(A.shape[0], B.shape[1]))
    acc = torch.zeros((n_out, bsz, bsz), dtype=torch.float32, device=dev)
    Ab = A.blocks.float()
    Bb = Ab if B.blocks is A.blocks else B.blocks.float()
    for p0 in range(0, P, pair_chunk):
        p1 = min(P, p0 + pair_chunk)
        acc = _numeric_chunk(Ab, Bb,
                             *(torch.from_numpy(a[p0:p1]).to(dev)
                               for a in (ia, ib, seg)),
                             acc, n_out=n_out, mxu=mxu, bsz=bsz)
    indptr = np.cumsum(np.bincount(out_r + 1, minlength=A.shape[0] // bsz
                                   + 1))
    return BSR(blocks=acc.to(A.blocks.dtype),
               indices=torch.from_numpy(out_c.astype(np.int32)).to(dev),
               indptr=torch.from_numpy(indptr.astype(np.int32)).to(dev),
               shape=(A.shape[0], B.shape[1]))


def spgemm_bsr_scipy(A_sp, B_sp, block: int = 8, device="cuda", **kw):
    """Convenience: scipy in, BSR C out (on `device`) via spgemm_bsr. The
    reference's docstring promises (BSR C, scipy C); it returns the BSR
    only, and so does the port."""
    A = BSR.from_scipy(A_sp, block=block, device=device)
    B = BSR.from_scipy(B_sp, block=block, device=device)
    return spgemm_bsr(A, B, **kw)
