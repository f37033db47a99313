"""Key-value merge-path sort (argsort / sort-by-key) on the card.

Port of ``libhpc_tpu/ops/sort_pallas_kv.py``: the merge-path sort of
``ops/sort_merge.py`` with a 32-bit payload moving with every key.

  K11  ``chunk_sort_kv_kernel`` (``csrc/sort_chunk.cu:sort_chunk_kv_i32``,
       the port of ``_chunk_kernel_kv``): chunks of up to 2^LOG2C_KERNEL
       keys with their payloads, sorted by K8's block radix sort with the
       payloads scattered beside the keys (a rank-stable (key, payload)
       scatter, as libHPC's cuda_radix_scatter.cuh, inside a block). It reads
       the keys past a short segment as the pad (key 0xFFFFFFFF, payload
       0). The default chunk of 2^15 is sorted as 2^LOG2C_KERNEL
       sub-chunks and K12 levels (``_chunk_sort_kv``).
  K12  ``_merge_level_kv`` / ``_merge_pair_kv``
       (``csrc/sort_merge.cu:sort_merge_kv_i32``, the port of
       ``_merge_kernel_kv`` as ``_run_merge_kv`` calls it): K9's
       merge-path kernel with a payload beside every key, for a level (one
       source) and a pair merge (two sources), windows of
       2^min(log2w, LOG2W_KERNEL) keys and payloads.

Keys keep ``sort_merge``'s layout and flipped domain; the payload buffers
lie beside the key buffers at the same offsets. The merge-path splits come
from ``sort_merge``'s split kernel (``_level_plan`` / ``_pair_plan``; on the
CPU ``_level_scalars`` / ``_pair_scalars``) on the key buffers; their
splits are clamped into the searched range, where the reference's
fixed-count search can end one past the A run when ties sit at a run's
maximum, which moves no key but repeats one payload and drops another
(ROADMAP Queue 3).

NOT stable, as the reference is not: equal keys keep an arbitrary payload
order. The plain versions (``*_torch``) sort stably. K11 is stable within
a chunk (a descending chunk is the mirror image of the ascending sort), so
it equals its plain version exactly; K12 agrees exactly where the keys
are distinct, and as a multiset of payloads per key elsewhere.

Payload repair (where the reference loses payloads): pad elements carry key
0xFFFFFFFF, and a masked merge candidate is +inf, so in the reference both
tie with real keys of the top value and can take their place (ROADMAP
Queue 3). Here K12 reads no candidate past a run (the plain version lets a
masked candidate lose every tie), and ``merge_sort_kv_u32`` writes the
payloads of the output's trailing run of 0xFFFFFFFF keys from the input's,
so every input payload appears exactly once, beside its own key.

Dispatch: CPU tensors take the plain versions; CUDA tensors launch the
kernels or raise. A numpy input is moved to ``device`` (default
``"cuda"``). ``CHUNK_LAUNCHES`` counts K11 launches, ``MERGE_LAUNCHES``
K12 launches and ``PAIR_LAUNCHES`` those of them that were pair merges.
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.ops._cuda_utils import (as_tensor, check_launch,
                                              check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)
from libhpc_tpu_torch.ops.sort import as_u32, u32_bits
from libhpc_tpu_torch.ops import sort_merge as sm
from libhpc_tpu_torch.ops.sort_merge import (FLIP, LANE, PLAN_ROWS, POS_INF,
                                             DEFAULT_LOG2W, _decompose,
                                             _level_plan, _level_scalars,
                                             _padded, _pair_plan, _pair_rows,
                                             _pair_scalars)

# the reference's kv chunk networks carry twice the live state of its
# scalar ones; it caps them at 2^15
DEFAULT_LOG2C = 15

# K11: chunks of up to 2^14 keys and payloads (the kernel's limit), in
# sort_merge.RADIX_BITS digits: the fastest 2^15 chunk sort of
# chip_smoke.py's chunk_sort_sweep
LOG2C_KERNEL = 14

CHUNK_LAUNCHES = 0
MERGE_LAUNCHES = 0
PAIR_LAUNCHES = 0


# ---------------------------------------------------------------------------
# chunk sort (K11)
# ---------------------------------------------------------------------------


def _buffers(P: int, pad_rows: int, total_rows: int, k, v, dev):
    """(total_rows, 128) key and payload buffers holding k, v at flat
    pad_rows*128; the rows around them unwritten, as the reference's."""
    bk = torch.empty(total_rows * LANE, dtype=torch.int32, device=dev)
    bv = torch.empty(total_rows * LANE, dtype=torch.int32, device=dev)
    bk[pad_rows * LANE:pad_rows * LANE + P] = k.reshape(-1)
    bv[pad_rows * LANE:pad_rows * LANE + P] = v.reshape(-1)
    return bk.reshape(total_rows, LANE), bv.reshape(total_rows, LANE)


def _chunk_sort_kv_torch(xk, xv, pad_rows: int, total_rows: int, *,
                         log2c: int, alternate: bool, invert: bool,
                         unflip: bool, P: int | None = None):
    """Plain version of K11: each 2^log2c chunk of (xk raw u32 bits, xv;
    padded to length P with key 0xFFFFFFFF, payload 0) sorted stably by
    key in the flipped domain, chunk c descending iff (alternate and c
    odd) != invert, keys unflipped if ``unflip``."""
    P = _padded(xk, P)
    if P > xk.shape[0]:
        xk = torch.cat([xk, xk.new_full((P - xk.shape[0],), -1)])
        xv = torch.cat([xv, xv.new_zeros((P - xv.shape[0],))])
    C = 1 << log2c
    n_chunks = P // C
    k, order = torch.sort((xk ^ FLIP).reshape(n_chunks, C), dim=1,
                          stable=True)
    v = torch.gather(xv.reshape(n_chunks, C), 1, order)
    c = torch.arange(n_chunks, device=xk.device)
    desc = ((((c & 1) == 1) & alternate) != invert)[:, None]
    k = torch.where(desc, k.flip(1), k)
    v = torch.where(desc, v.flip(1), v)
    if unflip:
        k = k ^ FLIP
    return _buffers(P, pad_rows, total_rows, k, v, xk.device)


def chunk_sort_kv_kernel(xk, xv, pad_rows: int, total_rows: int, *,
                         log2c: int, alternate: bool, invert: bool,
                         unflip: bool, P: int | None = None):
    """K11: the chunk sort of ``_chunk_sort_kv_torch`` for chunks of at
    most 2^LOG2C_KERNEL keys; the kernel reads the keys past xk's end as
    the pad. CUDA tensors launch the kernel or raise."""
    global CHUNK_LAUNCHES
    dev = kernel_device(xk, xv)
    if dev.type == "cpu":
        return _chunk_sort_kv_torch(xk, xv, pad_rows, total_rows,
                                    log2c=log2c, alternate=alternate,
                                    invert=invert, unflip=unflip, P=P)
    n = xk.shape[0]
    P = _padded(xk, P)
    C = 1 << log2c
    check_tensor(xk, "keys", dev, (torch.int32,), (n,))
    check_tensor(xv, "vals", dev, (torch.int32,), (n,))
    if not 1 <= log2c <= LOG2C_KERNEL or P % C:
        raise ValueError(f"kv chunk sort: P={P} in chunks of 2^{log2c}; the "
                         f"kernel takes 2^1..2^{LOG2C_KERNEL} dividing P")
    if pad_rows * LANE + P > total_rows * LANE or total_rows * LANE >= 1 << 31:
        raise ValueError(f"kv chunk sort: {P} elements at row {pad_rows} do "
                         f"not fit {total_rows} rows")
    bk = torch.empty((total_rows, LANE), dtype=torch.int32, device=dev)
    bv = torch.empty((total_rows, LANE), dtype=torch.int32, device=dev)
    fn = kernel_fn("sort_chunk_kv_i32", 4, 8)
    with torch.cuda.device(dev):
        rc = fn(xk.data_ptr(), xv.data_ptr(), bk.data_ptr(), bv.data_ptr(),
                n, P // C, log2c, pad_rows * LANE, int(alternate),
                int(invert), int(unflip), sm.RADIX_BITS, current_stream_ptr())
    check_launch(rc, "sort_chunk_kv_i32")
    CHUNK_LAUNCHES += 1
    return bk, bv


def _chunk_sort_kv(xk, xv, pad_rows: int, total_rows: int, *, log2c: int,
                   alternate: bool, invert: bool, unflip: bool,
                   P: int | None = None):
    """Sort each chunk of (keys, payloads), taken as P of each (default
    their length) whose last P - n are key 0xFFFFFFFF, payload 0, into
    padded work buffers at row ``pad_rows``, chunks alternating asc/desc
    (keys flipped unless unflip). A chunk larger than 2^LOG2C_KERNEL is
    sorted as sub-chunks (K11) and merge levels (K12) up to 2^log2c, as
    ``sort_merge._chunk_sort`` does."""
    P = _padded(xk, P)
    sub = min(log2c, LOG2C_KERNEL)
    staged = sub < log2c
    if staged and not alternate and P > 1 << log2c:
        raise ValueError("kv chunk sort: chunks of one direction are sorted "
                         f"only up to 2^{LOG2C_KERNEL} (or one chunk)")
    bk, bv = chunk_sort_kv_kernel(xk, xv, pad_rows, total_rows, log2c=sub,
                                  alternate=alternate or staged,
                                  invert=invert and not staged,
                                  unflip=unflip and not staged, P=P)
    for log2r in range(sub, log2c):
        last = log2r == log2c - 1
        bk, bv = _merge_level_kv(bk, bv, P, pad_rows * LANE, total_rows,
                                 log2r, min(sm.LOG2W_KERNEL, log2r),
                                 invert=invert and last,
                                 unflip=unflip and last)
    return bk, bv


# ---------------------------------------------------------------------------
# merge kernel (K12), shared by level merges and pair merges
# ---------------------------------------------------------------------------


def _merge_windows_kv_torch(srcAk, srcAv, srcBk, srcBv, scalars, PAD: int,
                            total_rows: int, log2w: int, unflip: bool):
    """Plain version of K12: per window, the candidates at sA = rowA*128 +
    dA and sB in the NOT-conjugated domain of a descending window, masked
    to +inf; the halver keeps B where its key is smaller, or equal with the
    A candidate masked (a masked candidate loses every tie); then the
    window sorted stably by key, payloads following."""
    rowA, dA, rowB, dB, kA, kB, dsc = (s.to(torch.int64) for s in scalars)
    W = 1 << log2w
    nw = rowA.shape[0]
    dev = srcAk.device
    idx = torch.arange(W, device=dev)
    desc = (dsc != 0)[:, None]
    dmask = -(dsc.to(torch.int32))[:, None]
    idx_eff = torch.where(desc, W - 1 - idx, idx)
    maskA = idx_eff >= (W - kA)[:, None]
    maskB = idx_eff < kB[:, None]

    def cand(srck, srcv, start, mask):
        fk, fv = srck.reshape(-1), srcv.reshape(-1)
        pos = torch.clamp(start[:, None] + idx, 0, fk.shape[0] - 1)
        return torch.where(mask, POS_INF, fk[pos] ^ dmask), fv[pos]

    ka, va = cand(srcAk, srcAv, rowA * LANE + dA, maskA)
    kb, vb = cand(srcBk, srcBv, rowB * LANE + dB, maskB)
    take_b = (kb < ka) | ((kb == ka) & maskA & ~maskB)
    k = torch.where(take_b, kb, ka)
    v = torch.where(take_b, vb, va)
    k, order = torch.sort(k, dim=1, stable=True)
    v = torch.gather(v, 1, order)
    out_mask = dmask ^ FLIP if unflip else dmask
    bk = torch.empty(total_rows * LANE, dtype=torch.int32, device=dev)
    bv = torch.empty(total_rows * LANE, dtype=torch.int32, device=dev)
    bk[PAD:PAD + nw * W] = (k ^ out_mask).reshape(-1)
    bv[PAD:PAD + nw * W] = v.reshape(-1)
    return bk.reshape(total_rows, LANE), bv.reshape(total_rows, LANE)


def _merge_launch_kv(srcAk, srcAv, srcBk, srcBv, plan, PAD: int,
                     total_rows: int, log2w: int, unflip: bool, pair: bool):
    """Launch K12 on CUDA tensors (a pair merge when ``pair``), its windows
    placed by the split kernel's plan."""
    global MERGE_LAUNCHES, PAIR_LAUNCHES
    srcs = (srcAk, srcAv, srcBk, srcBv)
    dev = kernel_device(*srcs, plan)
    nw = plan.shape[-1]
    for name, t in zip(("keysA", "valsA", "keysB", "valsB"), srcs):
        check_tensor(t, name, dev, (torch.int32,), (t.shape[0], LANE))
    if srcAk.shape != srcAv.shape or srcBk.shape != srcBv.shape:
        raise ValueError("kv merge: key and payload buffers differ in shape")
    check_tensor(plan, "plan", dev, (torch.int32,), (PLAN_ROWS, nw))
    if not 1 <= log2w <= sm.LOG2W_KERNEL:
        raise ValueError(f"kv merge window 2^{log2w}: the kernel takes "
                         f"2^1..2^{sm.LOG2W_KERNEL}")
    if PAD < 4 or PAD + (nw << log2w) > total_rows * LANE \
            or total_rows * LANE >= 1 << 31:
        raise ValueError(f"kv merge: {nw} windows at {PAD} do not fit "
                         f"{total_rows} rows (the kernel reads whole "
                         "16-byte chunks, so PAD >= 4)")
    bk = torch.empty((total_rows, LANE), dtype=torch.int32, device=dev)
    bv = torch.empty((total_rows, LANE), dtype=torch.int32, device=dev)
    fn = kernel_fn("sort_merge_kv_i32", 7, 4)
    with torch.cuda.device(dev):
        rc = fn(*(t.data_ptr() for t in srcs), plan.data_ptr(),
                bk.data_ptr(), bv.data_ptr(), nw, log2w, PAD, int(unflip),
                current_stream_ptr())
    check_launch(rc, "sort_merge_kv_i32")
    MERGE_LAUNCHES += 1
    PAIR_LAUNCHES += int(pair)
    return bk, bv


def _merge_level_kv_torch(bk, bv, P: int, PAD: int, total_rows: int,
                          log2r: int, log2w: int, invert: bool, unflip: bool):
    """Plain version of K12 for one level."""
    scalars = _level_scalars(bk, P, PAD, log2r, log2w, invert)
    return _merge_windows_kv_torch(bk, bv, bk, bv, scalars, PAD, total_rows,
                                   log2w, unflip)


def _merge_level_kv(bk, bv, P: int, PAD: int, total_rows: int, log2r: int,
                    log2w: int, invert: bool, unflip: bool):
    """K12 as a level: runs of 2^log2r -> 2^(log2r+1), payloads along."""
    if kernel_device(bk, bv).type == "cpu":
        return _merge_level_kv_torch(bk, bv, P, PAD, total_rows, log2r,
                                     log2w, invert, unflip)
    lw = min(log2w, sm.LOG2W_KERNEL)
    plan = _level_plan(bk, P, PAD, log2r, lw, invert)
    return _merge_launch_kv(bk, bv, bk, bv, plan, PAD, total_rows, lw,
                            unflip, pair=False)


def _merge_pair_kv_torch(bkA, bvA, bkB, bvB, LA: int, LB: int, PAD: int,
                         log2w: int, desc_out: bool, unflip: bool):
    """Plain version of K12 as a pair merge."""
    scalars = _pair_scalars(bkA, bkB, LA, LB, PAD, log2w, desc_out)
    return _merge_windows_kv_torch(bkA, bvA, bkB, bvB, scalars, PAD,
                                   _pair_rows(LA, LB, PAD), log2w, unflip)


def _merge_pair_kv(bkA, bvA, bkB, bvB, LA: int, LB: int, PAD: int,
                   log2w: int, desc_out: bool, unflip: bool):
    """K12 as a pair merge: segment A (ascending, LA) and B (descending
    storage, LB) into fresh buffers holding LA+LB at [PAD, PAD+LA+LB)."""
    if kernel_device(bkA, bvA, bkB, bvB).type == "cpu":
        return _merge_pair_kv_torch(bkA, bvA, bkB, bvB, LA, LB, PAD, log2w,
                                    desc_out, unflip)
    lw = min(log2w, sm.LOG2W_KERNEL)
    plan = _pair_plan(bkA, bkB, LA, LB, PAD, lw, desc_out)
    return _merge_launch_kv(bkA, bvA, bkB, bvB, plan, PAD,
                            _pair_rows(LA, LB, PAD), lw, unflip, pair=True)


# ---------------------------------------------------------------------------
# orchestration (mirrors sort_merge, payload buffers alongside)
# ---------------------------------------------------------------------------


def _sort_segment_kv(xk, xv, log2c: int, log2w: int, invert: bool,
                     unflip: bool, P: int | None = None):
    """Sort one power-of-two segment of (raw-bit int32 keys, int32
    payloads), taken as P of each (default their length) whose tail is
    key 0xFFFFFFFF, payload 0. Returns the padded key and payload buffers,
    data at [PAD, PAD+P) with PAD = max(2^log2w, 2^log2c)."""
    P = _padded(xk, P)
    C = 1 << log2c
    J = (P // C).bit_length() - 1
    PAD = max(1 << log2w, C)
    total_rows = (PAD + P + PAD + 16 * LANE) // LANE

    bk, bv = _chunk_sort_kv(xk, xv, PAD // LANE, total_rows, log2c=log2c,
                            alternate=(J > 0), invert=(invert and J == 0),
                            unflip=(unflip and J == 0), P=P)
    for j in range(1, J + 1):
        log2r = log2c + j - 1
        bk, bv = _merge_level_kv(bk, bv, P, PAD, total_rows, log2r,
                                 min(log2w, log2r),
                                 invert=(invert and j == J),
                                 unflip=(unflip and j == J))
    return bk, bv


def merge_sort_kv_u32(keys, vals, log2c: int = DEFAULT_LOG2C,
                      log2w: int = DEFAULT_LOG2W, *, device="cuda"):
    """Sort (keys, vals) by key ascending; returns (uint32 sorted keys,
    vals permuted) on the keys' device. vals: any 4-byte dtype, returned in
    that dtype (carried as its int32 bits). Not stable."""
    xk = u32_bits(keys, device)
    vals = as_tensor(vals, xk.device)
    if vals.shape != xk.shape or vals.element_size() != 4:
        raise ValueError(f"merge_sort_kv_u32: vals {vals.dtype} "
                         f"{tuple(vals.shape)} for keys {tuple(xk.shape)}; "
                         "one 4-byte payload a key")
    n = xk.shape[0]
    vdtype = vals.dtype
    if n <= 1:
        return as_u32(xk), vals
    xv = vals.contiguous().view(torch.int32)

    C = 1 << log2c
    segs = _decompose(n, C)
    single = len(segs) == 1
    PAD = max(1 << log2w, C)

    # the chunk sort pads the last segment (key 0xFFFFFFFF, payload 0) as
    # it reads it
    bufs = []
    off = 0
    for i, s in enumerate(segs):
        take = min(s, n - off)
        invert = (not single) and (i == len(segs) - 1)
        bufs.append(_sort_segment_kv(
            xk[off:off + take].contiguous(), xv[off:off + take].contiguous(),
            log2c, log2w, invert=invert, unflip=single, P=s))
        off += take

    if single:
        bk, bv = bufs[0]
    else:
        (bk, bv), L_acc = bufs[-1], segs[-1]
        for i in range(len(segs) - 2, -1, -1):
            (ak, av), LA = bufs[i], segs[i]
            last = i == 0
            total = LA + L_acc
            lw = min(log2w, (total & -total).bit_length() - 1)
            bk, bv = _merge_pair_kv(ak, av, bk, bv, LA, L_acc, PAD, lw,
                                    desc_out=not last, unflip=last)
            L_acc = total
    ok = bk.reshape(-1)[PAD:PAD + n]
    ov = bv.reshape(-1)[PAD:PAD + n]
    if sum(segs) > n:
        ov = _top_payloads(xk, xv, ok, ov)
    return as_u32(ok), ov.view(vdtype)


def _top_payloads(xk, xv, ok, ov):
    """Pads (key 0xFFFFFFFF, payload 0) tie with real keys of that value in
    the unstable merges, so some may end inside [0, n): give the output's
    trailing run of 0xFFFFFFFF keys the input's payloads of those keys, in
    input order (any order of equal keys is valid). Elementwise torch ops
    and one scatter, with no host synchronization, so a CUDA graph can
    capture the sort."""
    n = xk.shape[0]
    top = xk == -1
    rank = torch.cumsum(top, 0, dtype=torch.int32)       # 1..m at top keys
    m = rank[-1]
    i = torch.arange(n, dtype=torch.int32, device=xk.device)
    # top keys land at [n - m, n), the others on distinct slots past n
    dest = torch.where(top, rank + (n - 1) - m, i + n)
    moved = torch.empty(2 * n, dtype=torch.int32, device=xk.device)
    moved[dest] = xv
    return torch.where(ok == -1, moved[:n], ov)


def merge_argsort_u32(keys, log2c: int = DEFAULT_LOG2C,
                      log2w: int = DEFAULT_LOG2W, *, device="cuda"):
    """(sorted uint32, int32 order): keys[order] == sorted. Not stable."""
    xk = u32_bits(keys, device)
    idx = torch.arange(xk.shape[0], dtype=torch.int32, device=xk.device)
    return merge_sort_kv_u32(xk, idx, log2c=log2c, log2w=log2w)
