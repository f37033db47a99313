"""Merge-path sort — the large-array u32 sort on the card.

Port of ``libhpc_tpu/ops/sort_pallas.py``:

  phase 1  chunk sort   — ``_chunk_sort``: every 2^log2c chunk sorted, the
            chunks alternating ascending / descending. Kernel K8
            (``csrc/sort_chunk.cu:chunk_sort_kernel``, the port of
            ``_chunk_kernel``) sorts chunks of up to 2^LOG2C_KERNEL
            elements, one block a chunk, by an LSD radix sort in shared
            memory (digits of RADIX_BITS, 32 keys a thread, per-thread
            digit counters; each key read and written once in global
            memory); a larger chunk (the default 2^16) is sorted
            as 2^LOG2C_KERNEL sub-chunks followed by merge levels up to
            the chunk size.
            Merges of sorted runs are determined by the data, so the buffer
            equals the reference's chunk-sort output.
  phase 2  merge levels — ``_merge_level``: runs of R become runs of 2R.
            Each output window's sources are located by a merge-path binary
            search: the split kernel (``csrc/sort_merge.cu:
            split_search_kernel``, one launch a level, one thread a window)
            runs ``_level_scalars``' search on the card and writes its seven
            arrays and, eighth, the count of the window's outputs that come
            from A (``_level_plan``). Kernel K9 (``csrc/sort_merge.cu:
            merge_path_kernel``, the port of ``_merge_kernel``) then reads
            exactly those A and B elements and merges them along the merge
            path: one read and one write an element a level.
  fold     ``_merge_pair``: two separate buffers of unequal lengths merged
            the same way (``_pair_scalars``, ``_pair_plan``); K10, the port
            of ``_pair_merge_kernel``, is K9's kernel with two sources.

The reference's buffer layout and domain are kept, so every intermediate
buffer can be compared with the reference's over its data region: a
(total_rows, 128) int32 buffer holds the data at flat [PAD, PAD+P), keys in
the sign-flipped domain (x ^ 0x80000000, so int32 order is u32 order)
unless ``unflip``. Runs alternate ascending / descending by index, so an
ascending run and the next (descending) one form a bitonic sequence. Rows
outside the data region are left unwritten (``torch.empty``), as the
reference's are.

The window: the reference's default W = 2^17 (512 KB) does not fit shared
memory. The kernels take windows of W_h = 2^min(log2w, LOG2W_KERNEL) and
the search runs with that log2 W_h (``_level_scalars`` / ``_pair_scalars``
are generic in log2w); ``log2w`` still sets PAD and the buffer layout.
The kernel reads its candidates at sA = rowA*128 + dA directly: the
reference's rounding of rows to multiples of 8 is a TPU DMA constraint.

Dispatch: CPU tensors take the plain versions (``_chunk_sort_torch``,
``_merge_level_torch``, ``_merge_pair_torch``; the merge ones compute the
same windows from the same scalars with torch gathers and a sort per
window; ``_level_plan_torch`` / ``_pair_plan_torch`` are the split
kernel's); CUDA tensors launch the kernels or raise. ``CHUNK_LAUNCHES``
counts K8 launches, ``MERGE_LAUNCHES`` launches of the merge kernel (K9
and K10), ``PAIR_LAUNCHES`` those of them that were pair merges (K10),
``SPLIT_LAUNCHES`` those of the split kernel (one a merge, of this module's
and of the kv sort's).
The ``LIBHPC_SORT_*`` tuning knobs of the reference are TPU-only and not
ported.
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.ops._cuda_utils import (check_launch, check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)
from libhpc_tpu_torch.ops.sort import as_u32, u32_bits

LANE = 128
FLIP = -(2 ** 31)        # sign-bit flip: u32 order <-> i32 order
POS_INF = 2 ** 31 - 1    # +inf in flipped domain (= u32 0xFFFFFFFF)
NEG_INF = -(2 ** 31)

DEFAULT_LOG2C = 16
DEFAULT_LOG2W = 17

# K8: chunks of up to 2^14 keys (the kernel's limit) in 5-bit digits: the
# fastest 2^16 chunk sort of chip_smoke.py's chunk_sort_sweep
LOG2C_KERNEL = 14
RADIX_BITS = 5           # K8's and K11's digit width: 4, 5 or 6
LOG2W_KERNEL = 12        # K9/K10: 2^12 int32 = 16 KB a window
PLAN_ROWS = 8            # rowA dA rowB dB kA kB desc, and take

CHUNK_LAUNCHES = 0
MERGE_LAUNCHES = 0
PAIR_LAUNCHES = 0
SPLIT_LAUNCHES = 0


# ---------------------------------------------------------------------------
# phase 1: chunk sort (K8)
# ---------------------------------------------------------------------------


def _padded(x_i32, P: int | None):
    """x's length P (default its own): the keys past its end are the sort's
    pad, 0xFFFFFFFF, which K8 supplies itself."""
    n = x_i32.shape[0]
    if P is None or P == n:
        return n
    if P < n:
        raise ValueError(f"chunk sort: {n} keys do not fit a length of {P}")
    return P


def _chunk_sort_torch(x_i32, pad_rows: int, total_rows: int, *, log2c: int,
                      alternate: bool, invert: bool, unflip: bool,
                      P: int | None = None):
    """Plain version of K8: each 2^log2c chunk of x (raw u32 bits; padded
    with 0xFFFFFFFF to length P) sorted in the flipped domain by
    torch.sort, chunk c descending iff (alternate and c odd) != invert,
    unflipped if ``unflip``, at flat offset pad_rows*128 of a fresh
    (total_rows, 128) buffer."""
    P = _padded(x_i32, P)
    if P > x_i32.shape[0]:
        x_i32 = torch.cat([x_i32, x_i32.new_full((P - x_i32.shape[0],), -1)])
    C = 1 << log2c
    n_chunks = P // C
    s = torch.sort((x_i32 ^ FLIP).reshape(n_chunks, C), dim=1).values
    c = torch.arange(n_chunks, device=x_i32.device)
    desc = (((c & 1) == 1) & alternate) != invert
    s = torch.where(desc[:, None], s.flip(1), s)
    if unflip:
        s = s ^ FLIP
    out = torch.empty(total_rows * LANE, dtype=torch.int32,
                      device=x_i32.device)
    out[pad_rows * LANE:pad_rows * LANE + P] = s.reshape(-1)
    return out.reshape(total_rows, LANE)


def chunk_sort_kernel(x_i32, pad_rows: int, total_rows: int, *, log2c: int,
                      alternate: bool, invert: bool, unflip: bool,
                      P: int | None = None):
    """K8: the chunk sort of ``_chunk_sort_torch`` for chunks of at most
    2^LOG2C_KERNEL elements; the kernel reads the keys past x's end as the
    pad. CUDA tensors launch the kernel or raise."""
    global CHUNK_LAUNCHES
    dev = kernel_device(x_i32)
    if dev.type == "cpu":
        return _chunk_sort_torch(x_i32, pad_rows, total_rows, log2c=log2c,
                                 alternate=alternate, invert=invert,
                                 unflip=unflip, P=P)
    n = x_i32.shape[0]
    P = _padded(x_i32, P)
    C = 1 << log2c
    check_tensor(x_i32, "x", dev, (torch.int32,), (n,))
    if not 1 <= log2c <= LOG2C_KERNEL or P % C:
        raise ValueError(f"chunk sort: P={P} in chunks of 2^{log2c}; the "
                         f"kernel takes 2^1..2^{LOG2C_KERNEL} dividing P")
    if pad_rows * LANE + P > total_rows * LANE or total_rows * LANE >= 1 << 31:
        raise ValueError(f"chunk sort: {P} elements at row {pad_rows} do not "
                         f"fit {total_rows} rows")
    out = torch.empty((total_rows, LANE), dtype=torch.int32, device=dev)
    fn = kernel_fn("sort_chunk_i32", 2, 8)
    with torch.cuda.device(dev):
        rc = fn(x_i32.data_ptr(), out.data_ptr(), n, P // C, log2c,
                pad_rows * LANE, int(alternate), int(invert), int(unflip),
                RADIX_BITS, current_stream_ptr())
    check_launch(rc, "sort_chunk_i32")
    CHUNK_LAUNCHES += 1
    return out


def _chunk_sort(x_i32, pad_rows: int, total_rows: int, *, log2c: int,
                alternate: bool, invert: bool, unflip: bool,
                P: int | None = None):
    """Sort each chunk; write into a padded work buffer at row `pad_rows`.

    Input: (n,) int32 (u32 bit pattern), taken as P keys (default n) whose
    last P - n are 0xFFFFFFFF. Output: (total_rows, 128) int32 in flipped
    order domain (unless unflip), chunks alternating asc/desc.

    A chunk larger than 2^LOG2C_KERNEL is sorted as sub-chunks of that size
    (K8) and merge levels (K9) up to 2^log2c: sub-chunks and interior runs
    alternate, and the last doubling gives each chunk its direction
    ((chunk odd) != invert, as ``alternate`` asks, or ``invert`` for a lone
    chunk) and applies ``unflip``."""
    P = _padded(x_i32, P)
    sub = min(log2c, LOG2C_KERNEL)
    staged = sub < log2c
    if staged and not alternate and P > 1 << log2c:
        raise ValueError("chunk sort: chunks of one direction are sorted "
                         f"only up to 2^{LOG2C_KERNEL} (or one chunk)")
    buf = chunk_sort_kernel(x_i32, pad_rows, total_rows, log2c=sub,
                            alternate=alternate or staged,
                            invert=invert and not staged,
                            unflip=unflip and not staged, P=P)
    for log2r in range(sub, log2c):
        last = log2r == log2c - 1
        buf = _merge_level(buf, P, pad_rows * LANE, total_rows, log2r,
                           min(LOG2W_KERNEL, log2r),
                           invert=invert and last, unflip=unflip and last)
    return buf


# ---------------------------------------------------------------------------
# phase 2: merge-path split search + merge kernel (K9 / K10)
# ---------------------------------------------------------------------------


def _scalars_out(sA, sB, kA, kB, desc):
    """The reference's 7 int32 arrays from flat window starts: rows rounded
    down to a multiple of 8, the in-tile remainder, invalid-candidate
    counts and the direction."""
    rowA = (sA // (8 * LANE)) * 8
    rowB = (sB // (8 * LANE)) * 8
    return tuple(a.to(torch.int32) for a in (
        rowA, sA - rowA * LANE, rowB, sB - rowB * LANE, kA, kB, desc))


def _level_scalars(buf, P: int, PAD: int, log2r: int, log2w: int,
                   invert: bool):
    """Merge-path split for every output window of one level (vectorized
    binary search over windows).

    Runs of R=2^log2r alternate asc/desc; output runs of 2R likewise.
    Returns per-window scalars for the kernel: A/B window start rows +
    in-row remainders, invalid-candidate counts, desc flag.

    The search runs a fixed log2r + 1 steps, as the reference's does; with
    ties at a run's maximum the reference's can end one past the A run
    (ROADMAP Queue 3). Here the split is clamped into the searched range:
    the same keys come out either way, but a step past would repeat one
    payload and drop another in the key-value sort."""
    R = 1 << log2r
    W = 1 << log2w
    nw = P // W
    flat = buf.reshape(-1)

    w = torch.arange(nw, dtype=torch.int64, device=buf.device)
    out_pos = w * W
    pair = out_pos >> (log2r + 1)
    base = pair << (log2r + 1)
    o = out_pos - base
    desc = ((pair & 1) == 1) != invert

    lo = torch.clamp(o - R, min=0)
    hi = hi0 = torch.clamp(o, max=R)
    for _ in range(log2r + 1):
        mid = (lo + hi) >> 1
        kb = o - 1 - mid
        kbc = torch.clamp(kb, 0, R - 1)
        # asc: A[mid] <= B_rank(kb)    (B stored descending)
        # desc: A_top(mid) >= B_top(kb)
        ia = torch.where(desc, base + R - 1 - mid, base + mid)
        ib = torch.where(desc, base + R + kbc, base + 2 * R - 1 - kbc)
        va = flat[PAD + ia]
        vb = flat[PAD + ib]
        pred = (kb >= 0) & torch.where(desc, va >= vb, va <= vb)
        lo, hi = torch.where(pred, mid + 1, lo), torch.where(pred, hi, mid)
    split = torch.minimum(lo, hi0)
    rho = o - split

    sA = torch.where(desc, base + R - split - W, base + split) + PAD
    sB = torch.where(desc, base + R + rho, base + 2 * R - rho - W) + PAD
    kA = torch.clamp(split + W - R, min=0)   # invalid A candidates
    kB = torch.clamp(rho + W - R, min=0)     # invalid B candidates
    return _scalars_out(sA, sB, kA, kB, desc)


def _pair_scalars(bufA, bufB, LA: int, LB: int, PAD: int, log2w: int,
                  desc_out: bool):
    """Merge-path splits for one merge of A (ascending, length LA) with B
    (descending storage, length LB) — the unequal-run generalization of
    _level_scalars (its split clamped the same way). Output direction
    desc_out (uniform for the call)."""
    W = 1 << log2w
    nw = (LA + LB) // W
    fA = bufA.reshape(-1)
    fB = bufB.reshape(-1)

    o = torch.arange(nw, dtype=torch.int64, device=bufA.device) * W
    lo = torch.clamp(o - LB, min=0)
    hi = hi0 = torch.clamp(o, max=LA)
    for _ in range(min(LA, LB).bit_length() + 1):
        mid = (lo + hi) >> 1
        kb = o - 1 - mid
        kbc = torch.clamp(kb, 0, LB - 1)
        if desc_out:
            # beta = #A among top-o: A_top(mid) >= B_top(kb)
            va = fA[PAD + LA - 1 - mid]
            vb = fB[PAD + kbc]
            pred = (kb >= 0) & (va >= vb)
        else:
            # alpha = #A among o smallest: A[mid] <= B_rank(kb)
            va = fA[PAD + mid]
            vb = fB[PAD + LB - 1 - kbc]
            pred = (kb >= 0) & (va <= vb)
        lo, hi = torch.where(pred, mid + 1, lo), torch.where(pred, hi, mid)
    split = torch.minimum(lo, hi0)
    rho = o - split
    if desc_out:
        sA = LA - split - W
        sB = rho
    else:
        sA = split
        sB = LB - rho - W
    kA = torch.clamp(split + W - LA, min=0)
    kB = torch.clamp(rho + W - LB, min=0)
    desc = torch.full((nw,), bool(desc_out), device=bufA.device)
    return _scalars_out(sA + PAD, sB + PAD, kA, kB, desc)


def _take(scalars, PAD: int, LA: int, span: int, log2w: int):
    """Outputs of each window that come from A: the next window's split
    minus this one's, or LA - split at the last window of a run pair (span
    outputs: 2R for a level, LA + LB for a pair merge). The split is read
    back from sA (``_level_scalars``: sA = PAD + base + split ascending,
    PAD + base + LA - split - W descending)."""
    rowA, dA, *_, dsc = (s.to(torch.int64) for s in scalars)
    W = 1 << log2w
    out_pos = torch.arange(rowA.shape[0], device=rowA.device) * W
    base = out_pos // span * span
    at = rowA * LANE + dA - PAD - base
    split = torch.where(dsc != 0, LA - W - at, at)
    end = torch.cat([split[1:], split.new_full((1,), LA)])
    end = torch.where(out_pos - base + W == span, LA, end)
    return (end - split).to(torch.int32)


def _level_plan_torch(buf, P: int, PAD: int, log2r: int, log2w: int,
                      invert: bool):
    """Plain version of the split kernel for one level: ``_level_scalars``'
    seven arrays and ``_take``'s, as one (PLAN_ROWS, nw) int32 tensor."""
    sc = _level_scalars(buf, P, PAD, log2r, log2w, invert)
    R = 1 << log2r
    return torch.stack(sc + (_take(sc, PAD, R, 2 * R, log2w),))


def _pair_plan_torch(bufA, bufB, LA: int, LB: int, PAD: int, log2w: int,
                     desc_out: bool):
    """Plain version of the split kernel for a pair merge."""
    sc = _pair_scalars(bufA, bufB, LA, LB, PAD, log2w, desc_out)
    return torch.stack(sc + (_take(sc, PAD, LA, LA + LB, log2w),))


def _check_plan_inputs(name: str, bufs, reach, dev) -> None:
    """Each (buffer, flat extent) pair: an int32 (rows, 128) buffer on
    `dev` holding the extent the search reads, below 2^31 elements."""
    for t, n in zip(bufs, reach):
        check_tensor(t, name, dev, (torch.int32,), (t.shape[0], LANE))
        if n > t.numel() or t.numel() >= 1 << 31:
            raise ValueError(f"{name}: the search reads {n} elements of a "
                             f"buffer of {t.numel()} (< 2^31)")


def _level_plan(buf, P: int, PAD: int, log2r: int, log2w: int,
                invert: bool):
    """The split kernel for one level (``_level_plan_torch`` on the CPU):
    one launch, one thread a window; CUDA tensors launch it or raise."""
    global SPLIT_LAUNCHES
    dev = kernel_device(buf)
    if dev.type == "cpu":
        return _level_plan_torch(buf, P, PAD, log2r, log2w, invert)
    if not 1 <= log2w <= log2r + 1 or P % (2 << log2r) or PAD < 1:
        raise ValueError(f"split search: {P} elements in runs of 2^{log2r}, "
                         f"windows of 2^{log2w} at {PAD}")
    _check_plan_inputs("buf", (buf,), (PAD + P,), dev)
    nw = P >> log2w
    plan = torch.empty((PLAN_ROWS, nw), dtype=torch.int32, device=dev)
    fn = kernel_fn("sort_split_level_i32", 2, 5)
    with torch.cuda.device(dev):
        rc = fn(buf.data_ptr(), plan.data_ptr(), nw, log2w, PAD, log2r,
                int(invert), current_stream_ptr())
    check_launch(rc, "sort_split_level_i32")
    SPLIT_LAUNCHES += 1
    return plan


def _pair_plan(bufA, bufB, LA: int, LB: int, PAD: int, log2w: int,
               desc_out: bool):
    """The split kernel for a pair merge (``_pair_plan_torch`` on the
    CPU)."""
    global SPLIT_LAUNCHES
    dev = kernel_device(bufA, bufB)
    if dev.type == "cpu":
        return _pair_plan_torch(bufA, bufB, LA, LB, PAD, log2w, desc_out)
    if LA < 1 or LB < 1 or (LA + LB) % (1 << log2w) or PAD < 1:
        raise ValueError(f"split search: runs of {LA} and {LB}, windows of "
                         f"2^{log2w} at {PAD}")
    _check_plan_inputs("buf", (bufA, bufB), (PAD + LA + 1, PAD + LB), dev)
    nw = (LA + LB) >> log2w
    plan = torch.empty((PLAN_ROWS, nw), dtype=torch.int32, device=dev)
    fn = kernel_fn("sort_split_pair_i32", 3, 7)
    with torch.cuda.device(dev):
        rc = fn(bufA.data_ptr(), bufB.data_ptr(), plan.data_ptr(), nw, log2w,
                PAD, LA, LB, min(LA, LB).bit_length() + 1, int(desc_out),
                current_stream_ptr())
    check_launch(rc, "sort_split_pair_i32")
    SPLIT_LAUNCHES += 1
    return plan


def _merge_windows_torch(srcA, srcB, scalars, PAD: int, total_rows: int,
                         log2w: int, unflip: bool):
    """Plain version of the merge kernel: for each window, the candidate
    windows at sA = rowA*128 + dA and sB, the invalid candidates masked to
    +inf (positions mirrored for descending windows), all of it in the
    NOT-conjugated domain of a descending window; the bitonic halver
    (elementwise min) and its cleanup (here a sort); written at flat
    PAD + w*W of a fresh (total_rows, 128) buffer."""
    rowA, dA, rowB, dB, kA, kB, dsc = (s.to(torch.int64) for s in scalars)
    W = 1 << log2w
    nw = rowA.shape[0]
    dev = srcA.device
    idx = torch.arange(W, device=dev)
    desc = (dsc != 0)[:, None]
    dmask = -(dsc.to(torch.int32))[:, None]
    idx_eff = torch.where(desc, W - 1 - idx, idx)
    maskA = idx_eff >= (W - kA)[:, None]
    maskB = idx_eff < kB[:, None]

    def cand(src, start, mask):
        flat = src.reshape(-1)
        pos = torch.clamp(start[:, None] + idx, 0, flat.shape[0] - 1)
        return torch.where(mask, POS_INF, flat[pos] ^ dmask)

    w = torch.minimum(cand(srcA, rowA * LANE + dA, maskA),
                      cand(srcB, rowB * LANE + dB, maskB))
    w = torch.sort(w, dim=1).values
    out_mask = dmask ^ FLIP if unflip else dmask
    out = torch.empty(total_rows * LANE, dtype=torch.int32, device=dev)
    out[PAD:PAD + nw * W] = (w ^ out_mask).reshape(-1)
    return out.reshape(total_rows, LANE)


def _merge_launch(srcA, srcB, plan, PAD: int, total_rows: int,
                  log2w: int, unflip: bool, pair: bool):
    """Launch the merge kernel (K9; K10 when ``pair``) on CUDA tensors, its
    windows placed by the split kernel's plan."""
    global MERGE_LAUNCHES, PAIR_LAUNCHES
    dev = kernel_device(srcA, srcB, plan)
    nw = plan.shape[-1]
    for name, t in (("bufA", srcA), ("bufB", srcB)):
        check_tensor(t, name, dev, (torch.int32,), (t.shape[0], LANE))
    check_tensor(plan, "plan", dev, (torch.int32,), (PLAN_ROWS, nw))
    if not 1 <= log2w <= LOG2W_KERNEL:
        raise ValueError(f"merge window 2^{log2w}: the kernel takes "
                         f"2^1..2^{LOG2W_KERNEL}")
    if PAD < 4 or PAD + (nw << log2w) > total_rows * LANE \
            or total_rows * LANE >= 1 << 31:
        raise ValueError(f"merge: {nw} windows at {PAD} do not fit "
                         f"{total_rows} rows (the kernel reads whole "
                         "16-byte chunks, so PAD >= 4)")
    out = torch.empty((total_rows, LANE), dtype=torch.int32, device=dev)
    fn = kernel_fn("sort_merge_i32", 4, 4)
    with torch.cuda.device(dev):
        rc = fn(srcA.data_ptr(), srcB.data_ptr(), plan.data_ptr(),
                out.data_ptr(), nw, log2w, PAD, int(unflip),
                current_stream_ptr())
    check_launch(rc, "sort_merge_i32")
    MERGE_LAUNCHES += 1
    PAIR_LAUNCHES += int(pair)
    return out


def _merge_level_torch(buf, P: int, PAD: int, total_rows: int, log2r: int,
                       log2w: int, invert: bool, unflip: bool):
    """Plain version of K9 for one level."""
    scalars = _level_scalars(buf, P, PAD, log2r, log2w, invert)
    return _merge_windows_torch(buf, buf, scalars, PAD, total_rows, log2w,
                                unflip)


def _merge_level(buf, P: int, PAD: int, total_rows: int, log2r: int,
                 log2w: int, invert: bool, unflip: bool):
    """K9: one merge level, runs of 2^log2r -> 2^(log2r+1)."""
    if kernel_device(buf).type == "cpu":
        return _merge_level_torch(buf, P, PAD, total_rows, log2r, log2w,
                                  invert, unflip)
    lw = min(log2w, LOG2W_KERNEL)
    plan = _level_plan(buf, P, PAD, log2r, lw, invert)
    return _merge_launch(buf, buf, plan, PAD, total_rows, lw, unflip,
                         pair=False)


def _pair_rows(LA: int, LB: int, PAD: int) -> int:
    return (PAD + LA + LB + PAD + 16 * LANE) // LANE


def _merge_pair_torch(bufA, bufB, LA: int, LB: int, PAD: int, log2w: int,
                      desc_out: bool, unflip: bool):
    """Plain version of K10."""
    scalars = _pair_scalars(bufA, bufB, LA, LB, PAD, log2w, desc_out)
    return _merge_windows_torch(bufA, bufB, scalars, PAD,
                                _pair_rows(LA, LB, PAD), log2w, unflip)


def _merge_pair(bufA, bufB, LA: int, LB: int, PAD: int, log2w: int,
                desc_out: bool, unflip: bool):
    """K10: merge two sorted segments (A asc, B desc-stored) into a fresh
    padded buffer holding LA+LB sorted elements at [PAD, PAD+LA+LB)."""
    if kernel_device(bufA, bufB).type == "cpu":
        return _merge_pair_torch(bufA, bufB, LA, LB, PAD, log2w, desc_out,
                                 unflip)
    lw = min(log2w, LOG2W_KERNEL)
    plan = _pair_plan(bufA, bufB, LA, LB, PAD, lw, desc_out)
    return _merge_launch(bufA, bufB, plan, PAD, _pair_rows(LA, LB, PAD),
                         lw, unflip, pair=True)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _sort_segment(xi, log2c: int, log2w: int, invert: bool, unflip: bool,
                  P: int | None = None):
    """Sort a power-of-two-chunk segment. xi: raw-bit int32 keys, taken as
    P = C * 2^J keys (default its length) whose tail past xi is 0xFFFFFFFF.
    Returns the padded work buffer, data (flipped domain unless unflip) at
    [PAD, PAD+P), ascending (or descending when invert)."""
    P = _padded(xi, P)
    C = 1 << log2c
    W0 = 1 << log2w
    J = (P // C).bit_length() - 1

    PAD = max(W0, C)
    TAILPAD = PAD + 16 * LANE
    total_rows = (PAD + P + TAILPAD) // LANE

    # invert applies ONLY to the final level (or the lone chunk): interior
    # runs must keep the strict (asc, desc) pair alternation either way
    buf = _chunk_sort(xi, PAD // LANE, total_rows, log2c=log2c,
                      alternate=(J > 0), invert=(invert and J == 0),
                      unflip=(unflip and J == 0), P=P)
    for j in range(1, J + 1):
        log2r = log2c + j - 1
        lw = min(log2w, log2r)  # window never larger than a run
        buf = _merge_level(buf, P, PAD, total_rows, log2r, lw,
                           invert=(invert and j == J),
                           unflip=(unflip and j == J))
    return buf, PAD


def _decompose(n: int, C: int, max_segs: int = 3):
    """Split n into <= max_segs power-of-two segment sizes (each >= C),
    greedily by leading bits; the final segment pads the remainder up.
    Bounds total padding waste by ~12.5% (vs 2x for a single 2^k pad)."""
    if n <= C:
        return [C]
    segs = []
    rem = n
    while rem > 0:
        if len(segs) == max_segs - 1:
            segs.append(max(C, 1 << (rem - 1).bit_length()))
            break
        s = max(C, 1 << (rem.bit_length() - 1))
        segs.append(s)
        rem -= min(s, rem)
    # merging needs distinct fold steps; collapse equal tail segments that
    # a single power-of-two pad would cover anyway
    total = sum(segs)
    single = max(C, 1 << (n - 1).bit_length())
    if total >= single:
        return [single]
    return segs


def merge_sort_u32(x, log2c: int = DEFAULT_LOG2C,
                   log2w: int = DEFAULT_LOG2W, *,
                   device="cuda") -> torch.Tensor:
    """Sort uint32 ascending — chunk sort + merge-path levels.

    Arbitrary n: the input is decomposed into <=3 power-of-two segments
    (padding waste <=~12.5%), each sorted by the chunk+level pipeline, then
    folded with unequal-pair merge-path merges. log2c/log2w are the
    reference's tuning knobs (tests shrink them to exercise multi-level
    merges at small sizes). Returns a torch.uint32 tensor on x's device
    (numpy input is moved to ``device`` first).
    """
    xi = u32_bits(x, device)
    n = xi.shape[0]
    if n <= 1:
        return as_u32(xi)

    C = 1 << log2c
    segs = _decompose(n, C)
    single = len(segs) == 1

    # slice each segment; the chunk sort pads the last one (raw-domain u32
    # max = int32 -1 -> +inf) as it reads it
    bufs = []
    off = 0
    for i, s in enumerate(segs):
        take = min(s, n - off)
        seg = xi[off:off + take]
        # the last segment of a multi-segment sort is the first descending
        # merge operand; intermediate fold outputs stay descending too
        invert = (not single) and (i == len(segs) - 1)
        buf, _ = _sort_segment(seg.contiguous(), log2c, log2w, invert=invert,
                               unflip=single, P=s)
        bufs.append(buf)
        off += take

    PAD = max(1 << log2w, C)  # uniform across all segment buffers
    if single:
        return as_u32(bufs[0].reshape(-1)[PAD:PAD + n])

    # fold right-to-left: accumulated merge stays the descending B operand
    acc, L_acc = bufs[-1], segs[-1]
    for i in range(len(segs) - 2, -1, -1):
        ba, LA = bufs[i], segs[i]
        last = i == 0
        total = LA + L_acc
        # window must divide the merged length (and never exceed PAD)
        lw = min(log2w, (total & -total).bit_length() - 1)
        acc = _merge_pair(ba, acc, LA, L_acc, PAD, lw,
                          desc_out=not last, unflip=last)
        L_acc = total

    return as_u32(acc.reshape(-1)[PAD:PAD + n])
