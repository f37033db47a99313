"""SpGEMM: sparse x sparse matrix multiply.

Port of ``libhpc_tpu/ops/spgemm.py``. The reference computes in XLA, not
Pallas (sorts, scatters, gathers, segment sums), so the port computes with
torch ops on the operands' device. Both are two-pass algorithms, after
libHPC's count -> scan -> scatter skeleton (radix_sort_cpu.hpp:254-322):

  symbolic pass: the expansion size S = sum over (i, k) in A of nnz(B row
     k), exactly, from the two indptr arrays (count -> scan);
  numeric pass: the partial products as (row, col, val) triplets, sorted
     by (row, col), duplicates summed.

Three numeric strategies, by scale:

  spgemm           ELL-of-B expansion, O(nnzA x kB) memory;
  spgemm_blocked   the same a row block of A: O(block_nnz x kB);
  spgemm_windowed  the exact expansion in fixed windows of slots: O(window)
                   device memory whatever kB or nnzA. The symbolic pass and
                   each window's source deltas are host numpy (line for
                   line the reference's); the windows of a batch run as one
                   (batch, window) program on the card: scatters of the
                   deltas, cumsums, a stable sort a window, segment sums;
                   the seams between windows are merged on the host.

Output is COO (padded tails of explicit zeros where noted): every
downstream op is additive, so padding is harmless; ``tocsr()`` gives CSR.

Where the port differs: ``spgemm_expansion_size`` sums in int64 (the
reference's int32 sum wraps past 2^31); the reference's
``LIBHPC_SPGEMM_BATCH`` knob (relay round trips to a remote TPU) is not
read, ``batch`` keeps its default of 8; the reference overlaps one batch's
pull with the next batch's dispatch, which needs the TPU's asynchronous
dispatch, while here each batch is prepared, computed and pulled in order;
and each pull takes exactly the batch's largest entry count (the
reference rounds it up to 64Ki, a recompile guard of its fetch).
"""

from __future__ import annotations

import numpy as np
import torch

from libhpc_tpu_torch.sparse.coo import COO

_I32_MAX = 2**31 - 1


def _zero_coo(shape, dtype, device) -> COO:
    """The product with no entry: one zero entry at (0, 0), as the
    reference returns it."""
    z = torch.zeros((1,), dtype=torch.int32, device=device)
    return COO(row=z, col=z.clone(),
               data=torch.zeros((1,), dtype=dtype, device=device),
               shape=shape)


def spgemm_expansion_size(A_csr, B_csr) -> int:
    """Symbolic pass: exact expanded-product count (host scalar)."""
    lenB = B_csr.row_lengths()
    return int(lenB[A_csr.indices.long()].sum(dtype=torch.int64))


def _spgemm_numeric(A, B_ell, kB: int):
    nnzA = A.nnz
    idx = A.indices.long()
    # expanded partial products: (nnzA, kB)
    vals = A.data[:, None] * B_ell.vals[idx]
    cols = B_ell.cols[idx]
    rows = A.row_of_nnz()[:, None].expand(nnzA, kB)
    coo = COO(row=rows.reshape(-1).to(torch.int32),
              col=cols.reshape(-1).to(torch.int32),
              data=vals.reshape(-1),
              shape=(A.shape[0], B_ell.shape[1]))
    return coo.sum_duplicates()


def spgemm(A_csr, B_csr):
    """C = A @ B as padded COO. Setup (ELL pack of B) is host-side."""
    if A_csr.shape[1] != B_csr.shape[0]:
        raise ValueError(f"shape mismatch {A_csr.shape} @ {B_csr.shape}")
    B_ell = B_csr.to_ell()
    return _spgemm_numeric(A_csr, B_ell, B_ell.k)


def spgemm_csr(A_csr, B_csr):
    """C = A @ B as padded CSR."""
    return spgemm(A_csr, B_csr).tocsr()


def spgemm_blocked(A_csr, B_csr, row_block: int = 4096):
    """Memory-bounded SpGEMM: A in row blocks, so the expansion buffer
    stays O(row_block_nnz x kB) instead of O(nnzA x kB). A host loop over
    per-block numeric passes; returns padded COO."""
    from libhpc_tpu_torch.sparse.csr import CSR

    if A_csr.shape[1] != B_csr.shape[0]:
        raise ValueError(f"shape mismatch {A_csr.shape} @ {B_csr.shape}")
    B_ell = B_csr.to_ell()
    m = A_csr.shape[0]
    indptr_np = A_csr.indptr.cpu().numpy()
    rows_list, cols_list, data_list = [], [], []
    for r0 in range(0, m, row_block):
        r1 = min(m, r0 + row_block)
        p0, p1 = int(indptr_np[r0]), int(indptr_np[r1])
        if p1 == p0:
            continue
        blk = CSR(
            data=A_csr.data[p0:p1],
            indices=A_csr.indices[p0:p1],
            indptr=A_csr.indptr[r0:r1 + 1] - p0,
            shape=(r1 - r0, A_csr.shape[1]),
        )
        c = _spgemm_numeric(blk, B_ell, B_ell.k)
        rows_list.append(c.row + r0)
        cols_list.append(c.col)
        data_list.append(c.data)
    if not rows_list:
        return _zero_coo((m, B_ell.shape[1]), A_csr.dtype, A_csr.device)
    return COO(
        row=torch.cat(rows_list).to(torch.int32),
        col=torch.cat(cols_list).to(torch.int32),
        data=torch.cat(data_list),
        shape=(m, B_ell.shape[1]),
    )


# ---------------------------------------------------------------------------
# windowed exact-expansion SpGEMM (the at-scale path)
# ---------------------------------------------------------------------------


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    """Cumsum along dim 1 of an int32 tensor that wraps as the reference's
    int32 cumsum does: summed in int64, the low 32 bits kept (two's
    complement)."""
    t = torch.cumsum(x, dim=1, dtype=torch.int64)
    return (((t + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _scatter_set(W: int, fill: int, heads, vals) -> torch.Tensor:
    """(G, W) int32 of `fill` with vals set at heads; heads equal to W
    (pad sources) are dropped, as the reference's ``mode="drop"``: they
    land in an extra column that is cut off."""
    G = heads.shape[0]
    out = torch.full((G, W + 1), fill, dtype=torch.int32,
                     device=heads.device)
    out.scatter_(1, heads.long(), vals)
    return out[:, :W]


def _spgemm_window(heads, drel, drow, dabits, n_valid,
                   B_indices, B_data, W: int, SRC: int, CBITS: int):
    """Numeric pass for G expansion windows of W slots each (the
    reference's one window, vmapped over G: here a leading dimension).

    Host-prepared per-source DELTA arrays, all (G, SRC) int32 (pad sources
    carry head slot W, which the scatters drop):
      heads   window-local start slot of each source
      drel    first difference of (B start offset - global slot start +
              w0) a source, so the cumsum of ones with drel set at heads is
              the absolute B entry index of every slot
      drow    first difference of (source row - row_min)
      dabits  first difference of the A values' f32 BIT PATTERNS (int32
              wraparound arithmetic is exact, so the cumsum rebuilds each
              source's f32 bits exactly)
    n_valid: (G,) live slots of each window (the last one's tail is dead).

    The (row, col) pair is packed into one positive int32 key
    ((row - row_min) << CBITS | col; the host checks that the relative row
    fits 31 - CBITS bits) and sorted, stably, with its value.

    Returns (key, val, n_entries), each window sorted, deduplicated and
    zero-padded: (G, W) int32, (G, W) values, (G,) int32.
    """
    dev = heads.device
    s = torch.arange(W, dtype=torch.int32, device=dev)
    valid = s[None, :] < n_valid[:, None]
    idxB = _cumsum32(_scatter_set(W, 1, heads, drel))
    idxB = torch.where(valid, idxB, 0).long()
    row_rel = _cumsum32(_scatter_set(W, 0, heads, drow))
    abits = _cumsum32(_scatter_set(W, 0, heads, dabits))
    aval = abits.view(torch.float32)
    key = (row_rel << CBITS) | B_indices[idxB]
    key = torch.where(valid, key, _I32_MAX)
    val = torch.where(valid, aval * B_data[idxB], 0)

    key, order = torch.sort(key, dim=1, stable=True)
    val = val.gather(1, order)
    is_head = torch.cat([valid[:, :1], key[:, 1:] != key[:, :-1]], dim=1)
    is_head &= valid
    seg = (torch.cumsum(is_head, dim=1) - 1).clamp_min(0)
    data = torch.zeros_like(val).scatter_add_(1, seg, val)
    # one head a segment: its key is the segment's key
    kk = torch.zeros((key.shape[0], W + 1), dtype=torch.int32, device=dev)
    kk.scatter_(1, torch.where(is_head, seg, W), key)
    n_entries = is_head.sum(dim=1, dtype=torch.int32)
    keep = s[None, :] < n_entries[:, None]
    return (torch.where(keep, kk[:, :W], 0), torch.where(keep, data, 0),
            n_entries)


def _symbolic_windows(A_csr, B_csr, W: int):
    """The symbolic pass (host numpy: count -> exclusive scan): every
    partial product A[i,k] * B[k,j] gets one slot of a global expansion of
    size S, cut into windows of W slots. Returns None when S is 0, else a
    dict of the plan (per-source starts, rows, A bits and B starts; each
    window's source range [jlo, jhi); SRC and CBITS)."""
    m, n_out = A_csr.shape[0], B_csr.shape[1]
    a_ind = A_csr.indices.cpu().numpy()
    a_ptr = A_csr.indptr.cpu().numpy().astype(np.int64)
    b_ptr = B_csr.indptr.cpu().numpy().astype(np.int64)
    a_dat = A_csr.data.cpu().numpy()
    lens_all = (b_ptr[a_ind + 1] - b_ptr[a_ind]).astype(np.int64)
    rows_all = np.repeat(np.arange(m, dtype=np.int32), np.diff(a_ptr))
    live = lens_all > 0                      # empty B rows own no slots
    lens_l = lens_all[live]
    if lens_l.size == 0:
        return None
    starts = np.concatenate([[0], np.cumsum(lens_l)])   # (nsrc+1,) int64
    S = int(starts[-1])
    rows_l = rows_all[live]
    adata_l = a_dat[live]
    bstart_l = b_ptr[a_ind[live]]            # B row start of each source

    n_win = -(-S // W)
    # per-window source ranges [jlo, jhi): jlo covers the window's slot 0
    w0s = np.arange(n_win, dtype=np.int64) * W
    jlo = np.searchsorted(starts, w0s, side="right") - 1
    jhi = np.searchsorted(starts, np.minimum(w0s + W, S), side="left")
    SRC = int(np.max(jhi - jlo))

    # packed-key feasibility: the relative row must fit 31 - CBITS bits;
    # expansion slots are row-contiguous, so the span shrinks linearly
    # with the window size
    CBITS = max(int(n_out - 1).bit_length(), 1)
    span = int(np.max(rows_l[np.minimum(jhi - 1, rows_l.size - 1)]
                      .astype(np.int64) - rows_l[jlo]))
    if span >= 1 << max(31 - CBITS, 0):
        raise ValueError(
            f"spgemm_windowed: a window spans {span} output rows, too "
            f"wide to pack with {CBITS} column bits — pass a smaller "
            f"`window` (currently {W})")
    if adata_l.dtype != np.float32:   # explicit, documented downcast
        adata_l = adata_l.astype(np.float32)
    return dict(S=S, n_win=n_win, w0s=w0s, jlo=jlo, jhi=jhi, SRC=SRC,
                CBITS=CBITS, starts=starts, rows_l=rows_l,
                abits_l=adata_l.view(np.int32), bstart_l=bstart_l)


def _prep_batch(plan, W: int, G: int, b0: int):
    """Host deltas of windows [b0, b0 + G) (pad windows have no live
    slot): (heads, drel, drow, dabits, n_valid) as numpy, each window's
    row_min, and the number of real windows."""
    n_win, SRC, S = plan["n_win"], plan["SRC"], plan["S"]
    jlo, jhi, w0s = plan["jlo"], plan["jhi"], plan["w0s"]
    starts, rows_l = plan["starts"], plan["rows_l"]
    abits_l, bstart_l = plan["abits_l"], plan["bstart_l"]
    b1 = min(n_win, b0 + G)
    heads_b = np.full((G, SRC), W, np.int32)   # pad sources: dropped
    drel_b = np.zeros((G, SRC), np.int32)
    drow_b = np.zeros((G, SRC), np.int32)
    dab_b = np.zeros((G, SRC), np.int32)
    nval_b = np.zeros((G,), np.int32)          # pad windows: 0 live
    rmin_b = np.zeros((G,), np.int32)
    for i, w in enumerate(range(b0, b1)):
        lo, hi = int(jlo[w]), int(jhi[w])
        w0 = int(w0s[w])
        st = np.maximum(starts[lo:hi], w0)
        heads_b[i, :hi - lo] = (st - w0).astype(np.int32)
        # absolute B index of each source's slots: relabs[j] + s
        relabs = (bstart_l[lo:hi] - starts[lo:hi] + w0).astype(np.int64)
        drel = np.empty(hi - lo, np.int64)
        drel[0] = relabs[0]
        drel[1:] = np.diff(relabs) + 1
        drel_b[i, :hi - lo] = drel.astype(np.int32)
        rw = rows_l[lo:hi].astype(np.int32)
        drow_b[i, 0] = 0
        drow_b[i, 1:hi - lo] = np.diff(rw)
        ab = abits_l[lo:hi].astype(np.int64)
        dab_b[i, 0] = np.int64(ab[0]).astype(np.int32)
        dab_b[i, 1:hi - lo] = np.diff(ab).astype(np.int32)
        nval_b[i] = min(W, S - w0)
        rmin_b[i] = rw[0]
    return (heads_b, drel_b, drow_b, dab_b, nval_b), rmin_b, b1 - b0


def _pull_batch(out, rmin_b, nb: int, CBITS: int):
    """Copy one batch's entries to the host: [(rows, cols, data)] a
    window, each row-major sorted."""
    kk, dd, ne = out
    nes = ne.cpu().numpy()
    q = max(int(nes.max()), 1)
    kq, dq = kk[:, :q].cpu().numpy(), dd[:, :q].cpu().numpy()
    cmask = (1 << CBITS) - 1
    return [((kq[i, :int(nes[i])] >> CBITS) + rmin_b[i],
             kq[i, :int(nes[i])] & cmask, dq[i, :int(nes[i])])
            for i in range(nb)]


def _merge_row(cs, ds):
    order = np.argsort(cs, kind="stable")
    cs, ds = cs[order], ds[order]
    head = np.ones(cs.size, bool)
    head[1:] = cs[1:] != cs[:-1]
    seg = np.cumsum(head) - 1
    dsum = np.zeros(int(seg[-1]) + 1, ds.dtype)
    np.add.at(dsum, seg, ds)
    return cs[head], dsum


def _merge_seams(windows):
    """Merge the seam duplicates of the windows' (rows, cols, data): each
    window is (row, col)-sorted and deduplicated, and consecutive windows
    share at most their ONE boundary output row (expansion slots are
    row-contiguous), so only seam rows are merged again. Returns numpy
    (r, c, d), possibly empty."""
    out_r, out_c, out_d = [], [], []
    pend = None                       # open boundary row (r, c, d)
    for r, c, d in windows:
        if r.size == 0:
            continue
        if pend is not None:
            if r[0] == pend[0][0]:
                cut = int(np.searchsorted(r, r[0], side="right"))
                cs, ds = _merge_row(np.concatenate([pend[1], c[:cut]]),
                                    np.concatenate([pend[2], d[:cut]]))
                pend = (np.full(cs.size, r[0], r.dtype), cs, ds)
                r, c, d = r[cut:], c[cut:], d[cut:]
                if r.size == 0:
                    continue      # the row goes on into the next window
            out_r.append(pend[0])
            out_c.append(pend[1])
            out_d.append(pend[2])
            pend = None
        # hold back this window's last row: the next may continue it
        cut = int(np.searchsorted(r, r[-1], side="left"))
        pend = (r[cut:], c[cut:], d[cut:])
        out_r.append(r[:cut])
        out_c.append(c[:cut])
        out_d.append(d[:cut])
    if pend is not None:
        out_r.append(pend[0])
        out_c.append(pend[1])
        out_d.append(pend[2])
    if not out_r:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.float32),)
    return (np.concatenate(out_r), np.concatenate(out_c),
            np.concatenate(out_d))


def spgemm_windowed(A_csr, B_csr, window: int = 1 << 21,
                    batch: int = 8) -> COO:
    """C = A @ B with O(batch * window) device memory: the exact expansion,
    no kB term.

    The symbolic pass (host numpy) gives every partial product one slot of
    a global expansion of size S; slots are processed in windows of
    `window`, `batch` windows at a time as one (batch, window) program on
    the operands' device, and each batch's compacted triplets are pulled
    to the host. Works at S > 2^31 (host offsets are int64; on-device
    positions are window-relative int32).

    Returns canonical sorted COO (exact nnz, duplicates merged): an entry
    split by a window seam is merged on the host.

    Values are processed in float32 (the delta form carries f32 bit
    patterns); f64 A values are downcast once at entry, explicitly.
    """
    if A_csr.shape[1] != B_csr.shape[0]:
        raise ValueError(f"shape mismatch {A_csr.shape} @ {B_csr.shape}")
    m, n_out = A_csr.shape[0], B_csr.shape[1]
    W, G = int(window), int(batch)
    dev = A_csr.device
    plan = _symbolic_windows(A_csr, B_csr, W)
    if plan is None:
        return _zero_coo((m, n_out), torch.float32, dev)
    windows = []
    for b0 in range(0, plan["n_win"], G):
        deltas, rmin_b, nb = _prep_batch(plan, W, G, b0)
        out = _spgemm_window(*(torch.from_numpy(a).to(dev) for a in deltas),
                             B_csr.indices, B_csr.data, W=W,
                             SRC=plan["SRC"], CBITS=plan["CBITS"])
        windows += _pull_batch(out, rmin_b, nb, plan["CBITS"])
    r, c, d = _merge_seams(windows)
    if r.size == 0:
        return _zero_coo((m, n_out), torch.float32, dev)
    return COO(row=torch.from_numpy(r.astype(np.int32)),
               col=torch.from_numpy(c.astype(np.int32)),
               data=torch.from_numpy(np.ascontiguousarray(d)),
               shape=(m, n_out)).to(dev)
