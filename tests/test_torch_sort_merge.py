"""The port's merge-path sort (libhpc_tpu_torch/ops/sort_merge.py) against
libhpc_tpu/ops/sort_pallas.py (CPU; the reference's Pallas kernels in
interpret mode, the port's plain torch versions).

Sizes are those of tests/test_sort_pallas.py (LOG2C, LOG2W = 10, 11: chunks
of 1024, windows of 2048), where the reference in interpret mode is quick
enough. Every result is an integer array and must be equal exactly: end to
end against the reference and np.sort, the merge-path helpers element for
element, the work buffers of the chunk sort, merge levels, pair merges and
whole segments over their data region [PAD, PAD+P) (rows outside it are
left unwritten by both packages).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhpc_tpu.ops import sort_pallas as ref
from libhpc_tpu_torch.ops import sort_merge as sm

LOG2C, LOG2W = 10, 11
C = 1 << LOG2C


def _u32(rng, n):
    return rng.integers(0, 2**32, size=n, dtype=np.uint32)


def _extremes(rng):
    x = _u32(rng, 2 * C)
    x[:100] = 0
    x[100:200] = 0xFFFFFFFF
    x[200:300] = 0x7FFFFFFF  # i32 sign boundary
    x[300:400] = 0x80000000
    return x


def _segmented_extremes(rng):
    x = _u32(rng, 5120)
    x[:50] = 0xFFFFFFFF
    x[50:100] = 0
    return x


# every fast-tier case of tests/test_sort_pallas.py
CASES = {
    **{f"edge{n}": (lambda rng, n=n: _u32(rng, n))
       for n in (1, 111, 256, 297, 500, 512, 1024, 3987)},
    **{f"multi_level{k}": (lambda rng, k=k: _u32(rng, k * C))
       for k in (2, 4, 8)},
    "non_power_of_two_chunks": lambda rng: _u32(rng, 3 * C + 77),
    "extreme_values": _extremes,
    "all_equal": lambda rng: np.full(4 * C, 0xDEADBEEF, np.uint32),
    "two_values": lambda rng: rng.choice(np.array([7, 2**31], np.uint32),
                                         size=4 * C),
    "presorted": lambda rng: np.sort(_u32(rng, 4 * C)),
    "reversed": lambda rng: np.sort(_u32(rng, 4 * C))[::-1].copy(),
    "segmented5120": lambda rng: _u32(rng, 5120),
    "segmented11300": lambda rng: _u32(rng, 11300),
    "segmented_extremes": _segmented_extremes,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_sort_u32_matches_reference(rng, case):
    x = CASES[case](rng)
    want = np.sort(x)
    got = sm.merge_sort_u32(x, log2c=LOG2C, log2w=LOG2W, device="cpu")
    assert got.dtype == torch.uint32 and got.shape == x.shape
    got = got.numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(ref.merge_sort_u32(x, log2c=LOG2C, log2w=LOG2W)))
    # torch input (uint32 and int32 bit patterns) gives the same result
    np.testing.assert_array_equal(
        sm.merge_sort_u32(torch.from_numpy(x.view(np.int32)),
                          log2c=LOG2C, log2w=LOG2W).numpy(), want)


@pytest.mark.parametrize("n", [3000, 70000])
def test_default_tuning(rng, n):
    """Default log2c/log2w: a sub-chunk input (the reference's
    test_default_tuning_small, held against it too) and a two-chunk one;
    the 2^16 chunks go through 2^13 sub-chunks and three merge levels."""
    x = _u32(rng, n)
    got = sm.merge_sort_u32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sort(x))
    if n == 3000:
        np.testing.assert_array_equal(got, np.asarray(ref.merge_sort_u32(x)))


def test_constants():
    assert (sm.LANE, sm.FLIP, sm.POS_INF, sm.NEG_INF) == (
        ref.LANE, int(ref.FLIP), int(ref.POS_INF), int(ref.NEG_INF))
    assert (sm.DEFAULT_LOG2C, sm.DEFAULT_LOG2W) == (16, 17) == (
        ref.DEFAULT_LOG2C, ref.DEFAULT_LOG2W)


@pytest.mark.parametrize("log2c", [10, 16])
def test_decompose(log2c):
    c = 1 << log2c
    for n in [1, c - 1, c, c + 1, 5120, 5137, 9216, 9300, 11264, 11300,
              10_000_000, 100_000_000, 500_000_000, (1 << 27) - 1, 1 << 27]:
        assert sm._decompose(n, c) == ref._decompose(n, c), n
    assert sm._decompose(100_000_000, 1 << 16) == [1 << 26, 1 << 24, 1 << 24]
    assert sm._decompose(500_000_000, 1 << 16) == [1 << 29]


def _runs_buffer(x, log2r, PAD):
    """A (total_rows, 128) int32 work buffer in the reference's layout:
    runs of 2^log2r of x in the flipped domain, alternating asc/desc, at
    [PAD, PAD+P); the rows around them zero. (test_chunk_sort holds its
    data region against the reference's own chunk sort.)"""
    P = x.shape[0]
    flipped = x.view(np.int32) ^ np.int32(sm.FLIP)
    runs = np.sort(flipped.reshape(-1, 1 << log2r), axis=1)
    runs[1::2] = runs[1::2, ::-1]
    flat = np.zeros(2 * PAD + P + 16 * 128, np.int32)
    flat[PAD:PAD + P] = runs.reshape(-1)
    return flat.reshape(-1, 128)


def _sorted_runs(rng, P, log2r, x=None):
    x = _u32(rng, P) if x is None else x
    PAD = max(1 << LOG2W, C)
    buf = _runs_buffer(x, log2r, PAD)
    return buf, PAD, buf.shape[0]


def _data(buf, PAD, P):
    return np.asarray(buf).reshape(-1)[PAD:PAD + P]


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("log2r,log2w", [(10, 10), (10, 8), (11, 11),
                                         (11, 5)])
def test_level_scalars(rng, log2r, log2w, invert):
    """The merge-path split of every window, element for element, on the
    same buffer (including windows smaller than a run, as the kernel uses,
    and ties)."""
    x = _u32(rng, 8 * C) % np.uint32(1000)
    buf, PAD, _ = _sorted_runs(rng, 8 * C, log2r, x)
    want = ref._level_scalars(jnp.asarray(buf), 8 * C, PAD, log2r, log2w,
                              invert)
    got = sm._level_scalars(torch.from_numpy(buf), 8 * C, PAD, log2r, log2w,
                            invert)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _plan_windows(srcA, srcB, plan, log2w, unflip):
    """What the merge-path kernel makes of a split plan: window w holds
    take[w] elements of A and W - take[w] of B, read where the kernel reads
    them (in the NOT-conjugated domain of a descending window, where both
    ascend), merged; (windows, each part ascending)."""
    rowA, dA, rowB, dB, _, _, dsc, take = plan.to(torch.int64)
    W = 1 << log2w
    j = torch.arange(W)
    desc = (dsc != 0)[:, None]
    m = -(dsc.to(torch.int32))[:, None]
    sA, sB = (rowA * 128 + dA)[:, None], (rowB * 128 + dB)[:, None]
    jy = j - take[:, None]
    x_at = torch.where(desc, sA + W - 1 - j, sA + j)
    y_at = torch.where(desc, sB + jy, sB + W - 1 - jy)
    from_x = j < take[:, None]
    fA, fB = srcA.reshape(-1), srcB.reshape(-1)
    v = torch.where(from_x, fA[x_at.clamp(0, fA.numel() - 1)],
                    fB[y_at.clamp(0, fB.numel() - 1)]) ^ m
    big = torch.iinfo(torch.int32).max
    parts_sorted = all(
        torch.equal(p, torch.sort(p, dim=1).values)
        for p in (torch.where(from_x, v, big),
                  torch.where(from_x, -big - 1, v)))
    out = torch.sort(v, dim=1).values ^ (m ^ sm.FLIP if unflip else m)
    return out.reshape(-1), parts_sorted


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("log2r,log2w", [(10, 10), (10, 8), (11, 11),
                                         (11, 5), (10, 11)])
def test_level_plan(rng, log2r, log2w, invert):
    """The split kernel's plain version (what ``_level_plan`` runs on the
    CPU): the reference's seven arrays, then the A-counts of each window,
    which place every window's elements exactly as the plain merge does."""
    P = 8 * C
    x = _u32(rng, P) % np.uint32(1000)
    buf, PAD, total_rows = _sorted_runs(rng, P, log2r, x)
    bt = torch.from_numpy(buf)
    plan = sm._level_plan(bt, P, PAD, log2r, log2w, invert)
    assert plan.dtype == torch.int32 and plan.shape == (8, P >> log2w)
    want = ref._level_scalars(jnp.asarray(buf), P, PAD, log2r, log2w, invert)
    for g, w in zip(plan[:7], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    take = plan[7].long()
    W = 1 << log2w
    assert int(take.min()) >= 0 and int(take.max()) <= W
    per_pair = take.reshape(-1, (2 << log2r) // W).sum(dim=1)
    assert torch.all(per_pair == 1 << log2r)
    for unflip in (False, True):
        got, parts_sorted = _plan_windows(bt, bt, plan, log2w, unflip)
        assert parts_sorted
        plain = sm._merge_level_torch(bt, P, PAD, total_rows, log2r, log2w,
                                      invert, unflip)
        np.testing.assert_array_equal(got.numpy(), _data(plain, PAD, P))


def _segment_pair(rng, LA, LB, ties):
    """Sorted segment buffers as the reference's _sort_segment leaves them
    (test_sort_segment holds their data regions against it): A ascending
    (length LA), B descending (length LB, invert=True)."""
    a, b = _u32(rng, LA), _u32(rng, LB)
    if ties:
        a, b = a % np.uint32(50), b % np.uint32(50)
    PAD = max(1 << LOG2W, C)
    bufA = _runs_buffer(a, LA.bit_length() - 1, PAD)
    bufB = _runs_buffer(b, LB.bit_length() - 1, PAD)
    flatB = bufB.reshape(-1)
    flatB[PAD:PAD + LB] = flatB[PAD:PAD + LB][::-1].copy()
    return bufA, bufB, PAD, a, b


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(99)
    return {(LA, LB, ties): _segment_pair(rng, LA, LB, ties)
            for LA, LB, ties in [(4096, 1024, False), (1024, 2048, True)]}


@pytest.mark.parametrize("desc_out", [False, True])
@pytest.mark.parametrize("log2w", [10, 7])
@pytest.mark.parametrize("key", [(4096, 1024, False), (1024, 2048, True)])
def test_pair_scalars(pairs, key, log2w, desc_out):
    bufA, bufB, PAD, _, _ = pairs[key]
    LA, LB, _ = key
    want = ref._pair_scalars(jnp.asarray(bufA), jnp.asarray(bufB), LA, LB,
                             PAD, log2w, desc_out)
    got = sm._pair_scalars(torch.from_numpy(bufA), torch.from_numpy(bufB),
                           LA, LB, PAD, log2w, desc_out)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("desc_out", [False, True])
@pytest.mark.parametrize("log2w", [10, 7])
@pytest.mark.parametrize("key", [(4096, 1024, False), (1024, 2048, True)])
def test_pair_plan(pairs, key, log2w, desc_out):
    """The split kernel's plain version for a pair merge: the reference's
    seven arrays, and A-counts that sum to LA and place every window."""
    bufA, bufB, PAD, _, _ = pairs[key]
    LA, LB, _ = key
    ta, tb = torch.from_numpy(bufA), torch.from_numpy(bufB)
    plan = sm._pair_plan(ta, tb, LA, LB, PAD, log2w, desc_out)
    want = ref._pair_scalars(jnp.asarray(bufA), jnp.asarray(bufB), LA, LB,
                             PAD, log2w, desc_out)
    for g, w in zip(plan[:7], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(plan[7].long().sum()) == LA and int(plan[7].min()) >= 0
    got, parts_sorted = _plan_windows(ta, tb, plan, log2w, True)
    assert parts_sorted
    plain = sm._merge_pair_torch(ta, tb, LA, LB, PAD, log2w, desc_out, True)
    np.testing.assert_array_equal(got.numpy(), _data(plain, PAD, LA + LB))


@pytest.mark.parametrize("desc_out,unflip", [(True, False), (False, True)])
@pytest.mark.parametrize("key", [(4096, 1024, False), (1024, 2048, True)])
def test_merge_pair(pairs, key, desc_out, unflip):
    """K10's plain version against the reference's _merge_pair, at the
    reference's window and at the smaller window the kernel uses."""
    bufA, bufB, PAD, a, b = pairs[key]
    LA, LB, _ = key
    want = _data(ref._merge_pair(jnp.asarray(bufA), jnp.asarray(bufB), LA,
                                 LB, PAD, 10, desc_out, unflip), PAD, LA + LB)
    merged = np.sort(np.concatenate([a, b]).view(np.int32) ^ np.int32(sm.FLIP))
    if desc_out:
        merged = merged[::-1]
    if unflip:
        merged = merged ^ np.int32(sm.FLIP)
    np.testing.assert_array_equal(want, merged)
    for lw in (10, 7):
        got = sm._merge_pair(torch.from_numpy(bufA), torch.from_numpy(bufB),
                             LA, LB, PAD, lw, desc_out, unflip)
        assert got.shape[0] == (2 * PAD + LA + LB + 2048) // 128
        np.testing.assert_array_equal(_data(got, PAD, LA + LB), want)


@pytest.mark.parametrize("invert,unflip", [(False, False), (True, True)])
@pytest.mark.parametrize("log2r", [10, 11])
def test_merge_level(rng, log2r, invert, unflip):
    """K9's plain version against the reference's _merge_level on the same
    buffer, at the reference's window and at smaller windows."""
    P = 8 * C
    buf, PAD, total_rows = _sorted_runs(rng, P, log2r)
    lw = min(LOG2W, log2r)
    want = _data(ref._merge_level(jnp.asarray(buf), P, PAD, total_rows,
                                  log2r, lw, invert, unflip), PAD, P)
    for w in (lw, 6):
        got = sm._merge_level(torch.from_numpy(buf), P, PAD, total_rows,
                              log2r, w, invert, unflip)
        assert got.shape == (total_rows, 128)
        np.testing.assert_array_equal(_data(got, PAD, P), want)


@pytest.mark.parametrize("alternate,invert,unflip", [
    (True, False, False), (True, True, True), (False, True, False),
    (False, False, True)])
def test_chunk_sort(rng, monkeypatch, alternate, invert, unflip):
    """K8's plain version, and the staged form the kernel path takes
    (sub-chunks + merge levels), against the reference's _chunk_sort (one
    chunk where all chunks sort one way, as the reference's segments do)."""
    P = 4 * C if alternate else C
    x = _u32(rng, P).view(np.int32)
    PAD = 2048
    total_rows = (2 * PAD + P + 2048) // 128
    want = _data(ref._chunk_sort(jnp.asarray(x), PAD // 128, total_rows,
                                 log2c=LOG2C, alternate=alternate,
                                 invert=invert, unflip=unflip), PAD, P)
    xt = torch.from_numpy(x)
    kw = dict(log2c=LOG2C, alternate=alternate, invert=invert, unflip=unflip)
    got = sm._chunk_sort(xt, PAD // 128, total_rows, **kw)
    assert got.shape == (total_rows, 128) and got.dtype == torch.int32
    np.testing.assert_array_equal(_data(got, PAD, P), want)
    if alternate and not (invert or unflip):
        # the layout the helper tests build in numpy
        np.testing.assert_array_equal(
            _data(_runs_buffer(x.view(np.uint32), LOG2C, PAD), PAD, P), want)
    for sub in (7, 9):
        monkeypatch.setattr(sm, "LOG2C_KERNEL", sub)
        staged = sm._chunk_sort(xt, PAD // 128, total_rows, **kw)
        np.testing.assert_array_equal(_data(staged, PAD, P), want)
    if not alternate:
        with pytest.raises(ValueError):
            sm._chunk_sort(torch.cat([xt, xt]), PAD // 128, total_rows, **kw)


@pytest.mark.parametrize("n", [1, C - 5, 3 * C + 77, 4 * C])
def test_chunk_sort_pads_a_short_input(rng, monkeypatch, n):
    """Keys past a short input's end count as 0xFFFFFFFF: the chunk sort
    of n keys at length 4C equals the reference's of the keys padded with
    0xFFFFFFFF, as merge_sort_u32 pads its last segment; the staged form
    too."""
    P = 4 * C
    x = _u32(rng, n).view(np.int32)
    padded = np.concatenate([x, np.full(P - n, -1, np.int32)])
    PAD = 2048
    total_rows = (2 * PAD + P + 2048) // 128
    kw = dict(log2c=LOG2C, alternate=True, invert=False, unflip=False)
    want = _data(ref._chunk_sort(jnp.asarray(padded), PAD // 128, total_rows,
                                 **kw), PAD, P)
    xt = torch.from_numpy(x)
    got = sm._chunk_sort(xt, PAD // 128, total_rows, P=P, **kw)
    np.testing.assert_array_equal(_data(got, PAD, P), want)
    monkeypatch.setattr(sm, "LOG2C_KERNEL", 8)
    staged = sm._chunk_sort(xt, PAD // 128, total_rows, P=P, **kw)
    np.testing.assert_array_equal(_data(staged, PAD, P), want)
    with pytest.raises(ValueError):
        sm._chunk_sort(xt, PAD // 128, total_rows, P=n - 1, **kw)


@pytest.mark.parametrize("invert,unflip", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_sort_segment(rng, invert, unflip):
    """The data region of a whole segment (chunk sort + 2 levels)."""
    x = _u32(rng, 4 * C).view(np.int32)
    want, PAD = ref._sort_segment(jnp.asarray(x), LOG2C, LOG2W, invert,
                                  unflip)
    got, pad = sm._sort_segment(torch.from_numpy(x), LOG2C, LOG2W, invert,
                                unflip)
    assert pad == PAD and got.shape == tuple(want.shape)
    want = _data(want, PAD, 4 * C)
    np.testing.assert_array_equal(_data(got, PAD, 4 * C), want)
    if not unflip:
        # the layout of the pair-merge tests' numpy buffers
        runs = _data(_runs_buffer(x.view(np.uint32), 12, PAD), PAD, 4 * C)
        np.testing.assert_array_equal(runs[::-1] if invert else runs, want)
