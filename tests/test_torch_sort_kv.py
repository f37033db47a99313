"""The port's key-value merge sort (libhpc_tpu_torch/ops/sort_merge_kv.py)
against libhpc_tpu/ops/sort_pallas_kv.py (CPU; the reference's Pallas
kernels in interpret mode, the port's plain torch versions).

Sizes are those of tests/test_sort_pallas_kv.py (LOG2C, LOG2W = 10, 11),
where the reference in interpret mode is quick enough; larger inputs are
held against numpy only. Neither sort is stable, so keys are compared
exactly and payloads as a multiset per key ((key, payload) pairs sorted);
payloads are compared exactly only where the keys are distinct, and so
are the intermediate payload buffers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhpc_tpu.ops import sort_pallas_kv as ref
from libhpc_tpu_torch.ops import sort_merge_kv as kv

LOG2C, LOG2W = 10, 11
C = 1 << LOG2C


def _u32(rng, n):
    return rng.integers(0, 2**32, size=n, dtype=np.uint32)


def _distinct(rng, n):
    return rng.choice(np.uint32(2**32 - 1), size=n, replace=False) \
        .astype(np.uint32)


def _pairs(k, v):
    """(key, payload bits) pairs sorted: the multiset a kv sort keeps."""
    k = np.asarray(k).view(np.uint32).astype(np.uint64)
    v = np.ascontiguousarray(np.asarray(v)).view(np.uint32).astype(np.uint64)
    return np.sort((k << np.uint64(32)) | v)


def _check_kv(k, v, ks, vs):
    """ks is np.sort(k), and every payload sits once beside its key."""
    np.testing.assert_array_equal(ks, np.sort(k))
    np.testing.assert_array_equal(_pairs(ks, vs), _pairs(k, v))


def _extremes(rng):
    x = _u32(rng, 2 * C)
    x[:100] = 0
    x[100:200] = 0xFFFFFFFF
    x[200:300] = 0x7FFFFFFF
    x[300:400] = 0x80000000
    return x


def _segmented_extremes(rng):
    x = _u32(rng, 5120)
    x[:50] = 0xFFFFFFFF
    x[50:100] = 0
    return x


# tests/test_sort_pallas_kv.py's cases (the slow ones too: the port's side
# is quick) and tests/test_torch_sort_merge.py's case set
CASES = {
    **{f"size{n}": (lambda rng, n=n: _u32(rng, n))
       for n in (1, 111, 256, 297, 500, 512, 1024, 3987, 4096, 5120,
                 11300)},
    **{f"multi_level{k}": (lambda rng, k=k: _u32(rng, k * C))
       for k in (2, 4, 8)},
    "non_power_of_two_chunks": lambda rng: _u32(rng, 3 * C + 77),
    "extreme_values": _extremes,
    "duplicate_keys4096": lambda rng: rng.choice(
        np.array([3, 7, 2**31, 0xFFFFFFFF], np.uint32), 4096),
    "all_equal2048": lambda rng: np.full(2048, 42, np.uint32),
    "two_values": lambda rng: rng.choice(np.array([7, 2**31], np.uint32),
                                         size=4 * C),
    "presorted": lambda rng: np.sort(_u32(rng, 4 * C)),
    "reversed": lambda rng: np.sort(_u32(rng, 4 * C))[::-1].copy(),
    "segmented_extremes": _segmented_extremes,
}
# held against the reference too (about 15 s a call in interpret mode):
# its own fast duplicate-key case, and a three-segment one with 0 and
# 0xFFFFFFFF keys
REF_CASES = {"duplicate_keys4096", "segmented_extremes"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_argsort_u32(rng, case):
    x = CASES[case](rng)
    n = x.size
    s, order = kv.merge_argsort_u32(x, log2c=LOG2C, log2w=LOG2W,
                                    device="cpu")
    assert s.dtype == torch.uint32 and order.dtype == torch.int32
    s, order = s.numpy(), order.numpy()
    np.testing.assert_array_equal(s, np.sort(x))
    np.testing.assert_array_equal(x[order], s)
    np.testing.assert_array_equal(np.sort(order), np.arange(n))
    if case in REF_CASES:
        rs, ro = ref.merge_argsort_u32(x, log2c=LOG2C, log2w=LOG2W)
        np.testing.assert_array_equal(np.asarray(rs), s)
        if np.unique(x).size == n:
            np.testing.assert_array_equal(np.asarray(ro), order)
        else:
            _check_kv(x, np.arange(n, dtype=np.int32), np.asarray(rs),
                      np.asarray(ro))


@pytest.mark.parametrize("n", [3 * 1024 + 17, 11300])
def test_sort_kv_f32_payload(rng, n):
    """tests/test_sort_pallas_kv.py's f32 payload case: payloads follow
    their keys exactly when the keys are distinct, in their own dtype."""
    k = _distinct(rng, n)
    v = rng.random(n).astype(np.float32)
    ks, vs = kv.merge_sort_kv_u32(torch.from_numpy(k), torch.from_numpy(v),
                                  log2c=LOG2C, log2w=LOG2W)
    assert vs.dtype == torch.float32
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ks.numpy(), k[order])
    np.testing.assert_array_equal(vs.numpy(), v[order])


@pytest.mark.parametrize("vdtype", [np.int32, np.uint32, np.float32])
def test_payload_dtypes(rng, vdtype):
    k = rng.integers(0, 50, 3000).astype(np.uint32)
    v = rng.integers(0, 2**31, 3000).astype(vdtype)
    ks, vs = kv.merge_sort_kv_u32(k, v, LOG2C, LOG2W, device="cpu")
    assert vs.numpy().dtype == vdtype
    _check_kv(k, v, ks.numpy(), vs.numpy())
    with pytest.raises(ValueError):
        kv.merge_sort_kv_u32(k, v.astype(np.int64), device="cpu")


@pytest.mark.parametrize("n", [3000, 70000, 200_003])
def test_default_tuning(rng, n):
    """Default log2c/log2w (2^15 chunks = 2^13 sub-chunks + two merge
    levels), against numpy."""
    k = rng.integers(0, 1000, n).astype(np.uint32)
    v = np.arange(n, dtype=np.int32)
    ks, vs = kv.merge_sort_kv_u32(torch.from_numpy(k), torch.from_numpy(v))
    _check_kv(k, v, ks.numpy(), vs.numpy())


@pytest.mark.parametrize("n,segs", [(700, [1024]), (1500, [2048]),
                                    (3987, [4096]), (2500, [2048, 1024]),
                                    (3000, [2048, 1024])])
@pytest.mark.parametrize("alphabet", [(5, 0xFFFFFFFF), (0, 5, 0xFFFFFFFF)])
def test_every_payload_once_top_key(n, segs, alphabet):
    """Keys of 0xFFFFFFFF (and 0, which the +inf fill of a descending
    window equals): every payload comes back once, beside its own key,
    through pads and segment folds. On these inputs the reference loses
    payloads of 0xFFFFFFFF keys (and of 0 keys), while its keys are right
    (ROADMAP Queue 3): the payloads are asserted of the port only."""
    rng = np.random.default_rng(n)
    assert kv._decompose(n, C) == segs
    v = np.arange(n, dtype=np.int32) + 1000
    k = rng.choice(np.array(alphabet, np.uint32), n)
    ks, vs = kv.merge_sort_kv_u32(k, v, LOG2C, LOG2W, device="cpu")
    _check_kv(k, v, ks.numpy(), vs.numpy())


def test_every_payload_once_ties_at_run_max():
    """2^20 keys of 16 values, 0 and 0xFFFFFFFF among them, at log2c = 10:
    with ties at a run's maximum the reference's fixed-count merge-path
    search ends one past the A run in some windows (kA > W), which moves
    no key but repeats one payload and drops another (ROADMAP Queue 3).
    The port clamps the split into the searched range and keeps every
    payload."""
    from libhpc_tpu_torch.ops import sort_merge as sm

    g = torch.Generator().manual_seed(1)
    alphabet = torch.cat([
        torch.tensor([0, 0x7FFFFFFF, -2**31, -1], dtype=torch.int32),
        torch.randint(-2**31, 2**31, (12,), dtype=torch.int32, generator=g)])
    P = 1 << 20
    k = alphabet[torch.randint(0, 16, (P,), generator=g)]
    v = torch.arange(P, dtype=torch.int32)
    ks, vs = kv.merge_sort_kv_u32(k.view(torch.uint32), v, LOG2C, LOG2W)
    _check_kv(k.numpy().view(np.uint32), v.numpy(), ks.numpy(), vs.numpy())
    # the level where the reference's split runs past: r = 2^15, W = 2^11
    PAD = 1 << LOG2W
    rows = (2 * PAD + P + 2048) // 128
    runs = torch.empty(rows * 128, dtype=torch.int32)
    runs[PAD:PAD + P] = kv._chunk_sort_kv_torch(
        k, v, PAD // 128, rows, log2c=15, alternate=True, invert=False,
        unflip=False)[0].reshape(-1)[PAD:PAD + P]
    runs = runs.reshape(rows, 128)
    W = 1 << LOG2W
    loose = ref._level_scalars(jnp.asarray(runs.numpy()), P, PAD, 15, LOG2W,
                               False)
    exact = sm._level_scalars(runs, P, PAD, 15, LOG2W, False)
    assert int(np.asarray(loose[4]).max()) > W >= int(exact[4].max())


def test_constants():
    assert kv.DEFAULT_LOG2C == ref.DEFAULT_LOG2C == 15
    assert kv.DEFAULT_LOG2W == ref.DEFAULT_LOG2W == 17


# ---- intermediate buffers against the reference's --------------------------


def _data(buf, PAD, P):
    return np.asarray(buf).reshape(-1)[PAD:PAD + P]


@pytest.mark.parametrize("alternate,invert,unflip", [
    (True, False, False), (False, True, True)])
def test_chunk_sort_kv(rng, monkeypatch, alternate, invert, unflip):
    """K11's plain version and the staged form the kernel path takes
    (sub-chunks + K12 levels) against the reference's _chunk_sort_kv, on
    distinct keys: key and payload buffers over their data region."""
    P = 4 * C if alternate else C
    x = _distinct(rng, P).view(np.int32)
    v = rng.integers(-2**31, 2**31, P).astype(np.int32)
    PAD = 2048
    rows = (2 * PAD + P + 2048) // 128
    kw = dict(log2c=LOG2C, alternate=alternate, invert=invert, unflip=unflip)
    wk, wv = ref._chunk_sort_kv(jnp.asarray(x), jnp.asarray(v), PAD // 128,
                                rows, **kw)
    wk, wv = _data(wk, PAD, P), _data(wv, PAD, P)
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    gk, gv = kv._chunk_sort_kv(xt, vt, PAD // 128, rows, **kw)
    assert gk.shape == gv.shape == (rows, 128)
    np.testing.assert_array_equal(_data(gk, PAD, P), wk)
    np.testing.assert_array_equal(_data(gv, PAD, P), wv)
    for sub in (7, 9):
        monkeypatch.setattr(kv, "LOG2C_KERNEL", sub)
        sk, sv = kv._chunk_sort_kv(xt, vt, PAD // 128, rows, **kw)
        np.testing.assert_array_equal(_data(sk, PAD, P), wk)
        np.testing.assert_array_equal(_data(sv, PAD, P), wv)


@pytest.mark.parametrize("n", [C - 5, 3 * C + 77])
def test_chunk_sort_kv_pads_a_short_input(rng, monkeypatch, n):
    """Keys past a short input's end count as 0xFFFFFFFF with payload 0:
    the kv chunk sort of n distinct keys at length 4C equals the
    reference's of the keys and payloads padded so, as merge_sort_kv_u32
    pads its last segment; the staged form too."""
    P = 4 * C
    x = _distinct(rng, n).view(np.int32)
    v = rng.integers(-2**31, 2**31, n).astype(np.int32)
    PAD = 2048
    rows = (2 * PAD + P + 2048) // 128
    kw = dict(log2c=LOG2C, alternate=True, invert=False, unflip=False)
    wk, wv = ref._chunk_sort_kv(
        jnp.asarray(np.concatenate([x, np.full(P - n, -1, np.int32)])),
        jnp.asarray(np.concatenate([v, np.zeros(P - n, np.int32)])),
        PAD // 128, rows, **kw)
    wk, wv = _data(wk, PAD, P), _data(wv, PAD, P)
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    gk, gv = kv._chunk_sort_kv(xt, vt, PAD // 128, rows, P=P, **kw)
    np.testing.assert_array_equal(_data(gk, PAD, P), wk)
    np.testing.assert_array_equal(_data(gv, PAD, P), wv)
    monkeypatch.setattr(kv, "LOG2C_KERNEL", 8)
    sk, sv = kv._chunk_sort_kv(xt, vt, PAD // 128, rows, P=P, **kw)
    np.testing.assert_array_equal(_data(sk, PAD, P), wk)
    np.testing.assert_array_equal(_data(sv, PAD, P), wv)
    with pytest.raises(ValueError):
        kv._chunk_sort_kv(xt, vt, PAD // 128, rows, P=n - 1, **kw)


def _runs(x, v, log2r, PAD, rows):
    """Work buffers of alternating sorted runs of distinct keys: the plain
    chunk sort's, which equal the reference's (test_chunk_sort_kv)."""
    return kv._chunk_sort_kv_torch(torch.from_numpy(x), torch.from_numpy(v),
                                   PAD // 128, rows, log2c=log2r,
                                   alternate=True, invert=False, unflip=False)


@pytest.mark.parametrize("log2r,invert,unflip", [(10, False, False),
                                                 (11, True, True)])
def test_merge_level_kv(rng, log2r, invert, unflip):
    """K12's plain version as a level against the reference's
    _run_merge_kv on the same buffers, at the reference's window and a
    smaller one."""
    P = 8 * C
    x = _distinct(rng, P).view(np.int32)
    v = np.arange(P, dtype=np.int32)
    PAD = 2048
    rows = (2 * PAD + P + 2048) // 128
    tk, tv = _runs(x, v, log2r, PAD, rows)
    bk, bv = jnp.asarray(tk.numpy()), jnp.asarray(tv.numpy())
    lw = min(LOG2W, log2r)
    scalars = ref._level_scalars(bk, P, PAD, log2r, lw, invert=invert)
    wk, wv = ref._run_merge_kv(scalars, (bk, bv, bk, bv), P >> lw, PAD, rows,
                               lw, unflip)
    for w in (lw, 6):
        gk, gv = kv._merge_level_kv(tk, tv, P, PAD, rows, log2r, w, invert,
                                    unflip)
        np.testing.assert_array_equal(_data(gk, PAD, P), _data(wk, PAD, P))
        np.testing.assert_array_equal(_data(gv, PAD, P), _data(wv, PAD, P))


@pytest.mark.parametrize("LA,LB,desc_out,unflip", [(4096, 1024, True, False),
                                                   (1024, 2048, False, True)])
def test_merge_pair_kv(rng, LA, LB, desc_out, unflip):
    """K12's plain version as a pair merge against the reference's, on
    segment buffers of distinct keys (A ascending, B descending, as
    _sort_segment_kv leaves them; test_sort_segment_kv holds those)."""
    x = _distinct(rng, LA + LB).view(np.int32)
    v = np.arange(LA + LB, dtype=np.int32)
    PAD = 1 << LOG2W
    ak, av = kv._sort_segment_kv(torch.from_numpy(x[:LA]),
                                 torch.from_numpy(v[:LA]), LOG2C, LOG2W,
                                 invert=False, unflip=False)
    bk, bv = kv._sort_segment_kv(torch.from_numpy(x[LA:]),
                                 torch.from_numpy(v[LA:]), LOG2C, LOG2W,
                                 invert=True, unflip=False)
    t = (ak, av, bk, bv)
    j = [jnp.asarray(a.numpy()) for a in t]
    total = LA + LB
    rows = (PAD + total + PAD + 2048) // 128
    scalars = ref._pair_scalars(j[0], j[2], LA, LB, PAD, 10,
                                desc_out=desc_out)
    wk, wv = ref._run_merge_kv(scalars, tuple(j), total >> 10, PAD, rows, 10,
                               unflip)
    merged = np.sort(x.view(np.uint32))
    np.testing.assert_array_equal(
        _data(wk, PAD, total).view(np.uint32) ^ np.uint32(0 if unflip
                                                          else 2**31),
        merged[::-1] if desc_out else merged)
    for lw in (10, 7):
        gk, gv = kv._merge_pair_kv(*t, LA, LB, PAD, lw, desc_out, unflip)
        assert gk.shape[0] == rows
        np.testing.assert_array_equal(_data(gk, PAD, total),
                                      _data(wk, PAD, total))
        np.testing.assert_array_equal(_data(gv, PAD, total),
                                      _data(wv, PAD, total))


@pytest.mark.parametrize("invert,unflip", [(False, False), (True, True)])
def test_sort_segment_kv(rng, invert, unflip):
    """Whole segments with ties: key buffers exactly and every payload
    beside its key. With key 0 among them the reference loses payloads of
    key 0 (it ties with the +inf fill of a descending window; ROADMAP
    Queue 3), so the port is held against its input here, and against the
    reference's buffers on distinct keys."""
    P = 4 * C
    PAD = 1 << LOG2W
    x = (_u32(rng, P) % np.uint32(300)).view(np.int32)
    v = np.arange(P, dtype=np.int32)
    gk, gv = kv._sort_segment_kv(torch.from_numpy(x), torch.from_numpy(v),
                                 LOG2C, LOG2W, invert, unflip)
    gk, gv = _data(gk, PAD, P), _data(gv, PAD, P)
    domain = x if unflip else x ^ np.int32(-2**31)
    want = np.sort(domain.view(np.uint32) ^ np.uint32(2**31)) \
        .view(np.int32) ^ np.int32(-2**31)
    np.testing.assert_array_equal(gk, want[::-1] if invert else want)
    np.testing.assert_array_equal(np.sort(gv), v)
    np.testing.assert_array_equal(gk, domain[gv])
    if invert:
        d = _distinct(rng, P).view(np.int32)
        wk, wv = ref._sort_segment_kv(jnp.asarray(d), jnp.asarray(v), LOG2C,
                                      LOG2W, invert, unflip)
        gk, gv = kv._sort_segment_kv(torch.from_numpy(d), torch.from_numpy(v),
                                     LOG2C, LOG2W, invert, unflip)
        assert gk.shape == tuple(wk.shape)
        np.testing.assert_array_equal(_data(gk, PAD, P), _data(wk, PAD, P))
        np.testing.assert_array_equal(_data(gv, PAD, P), _data(wv, PAD, P))
