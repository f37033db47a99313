"""A numpy model of the chunk sorts' block radix sort (K8, K11:
``libhpc_tpu_torch/csrc/sort_chunk.cu:chunk_sort_kernel``) against the
plain versions, which sort stably.

The model follows the kernel's index arithmetic: thread t's ITEMS = 32
items at positions t ITEMS + i, the direction by NOT conjugation (and the reversed
read of a descending chunk), the digits of the unsigned domain, the
per-thread counters packed two to a word (rows of digits, a column a
thread) and each item's rank among its thread's items of its digit, the
counters' exclusive scan in index order with the low digits' total
carried into the high halves, the scatter and the read-back into an
exchange buffer behind a one-in-32 padding, in 32-bit arithmetic. It
imports no JAX.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from libhpc_tpu_torch.ops import sort_merge as sm
from libhpc_tpu_torch.ops import sort_merge_kv as kv

from _torch_port import CHUNK_KEY_KINDS, chunk_keys

FULL = 0xFFFFFFFF
ITEMS = 32                 # keys a thread, as the kernel's
SOURCE = (pathlib.Path(sm.__file__).resolve().parents[1] / "csrc"
          / "sort_chunk.cu")


def _padx(e):
    return e + (e >> 5)


def _block(keys, vals, c, C, n_valid, desc, unflip, bits, items=ITEMS):
    """One block of chunk_sort_kernel<KV, bits> on chunk c of the
    raw keys (uint32, n_valid of them): its output keys and payloads (or
    None), C of each."""
    T = max(32, C // items)
    cp = T * items
    half = (1 << bits) // 2
    dmask = np.uint32(FULL if desc else 0)
    t = np.arange(T)[:, None]
    p = t * items + np.arange(items)[None]            # (T, items)
    g = c * C + np.where(desc, C - 1 - p, p)
    inside = (p < C) & (g < n_valid)
    at_g = np.clip(g, 0, n_valid - 1)
    key = np.where(p < C, np.where(inside, keys[at_g], FULL).astype(np.uint32)
                   ^ dmask, np.uint32(FULL)).astype(np.uint32)
    val = None if vals is None else np.where(inside, vals[at_g], 0)
    for shift in range(0, 32, bits):
        # row stride: T words and a spare one after every `half`, rounded
        # up to whole rows of banks; thread t's word of row k at
        # k S + t + t // half
        S = (T + T // half + 31) & ~31
        cnt = np.zeros(half * S, np.uint32)
        col = t[:, 0] + t[:, 0] // half
        entry = (np.arange(half)[:, None] * S + col[None]).reshape(-1)
        rank = np.zeros((T, items), np.int64)
        for i in range(items):
            d = (key[:, i] >> np.uint32(shift)) & np.uint32(2 * half - 1)
            at = (d % half).astype(np.int64) * S + col
            sh = np.uint32(16) * (d // half)
            rank[:, i] = (cnt[at] >> sh) & np.uint32(0xFF)
            cnt[at] += np.uint32(1) << sh
        assert rank.max() < items                   # a byte each
        # the raking scan: thread r's run of `half` entries, in order
        runs = np.arange(T)[:, None] * half + np.arange(half)[None]
        at_run = (runs // T) * S + runs % T + (runs % T) // half
        assert np.array_equal(at_run.reshape(-1), entry)
        assert np.all(at_run[:, 1:] - at_run[:, :-1] == 1)  # contiguous
        words = cnt[entry]
        assert (words & 0xFFFF).sum() + (words >> 16).sum() == cp
        excl = (np.cumsum(words, dtype=np.uint32) - words).astype(np.uint32)
        total = words.sum(dtype=np.uint32)
        cnt[entry] = excl + ((total & np.uint32(0xFFFF)) << np.uint32(16))
        ex = np.zeros(_padx(cp), np.uint32)
        exv = None if val is None else np.zeros(_padx(cp), val.dtype)
        seen = []
        for i in range(items):
            d = (key[:, i] >> np.uint32(shift)) & np.uint32(2 * half - 1)
            at = (d % half).astype(np.int64) * S + col
            sh = np.uint32(16) * (d // half)
            pos = ((cnt[at] >> sh) & np.uint32(0xFFFF)).astype(np.int64) \
                + rank[:, i]
            seen.append(pos)
            ex[_padx(pos)] = key[:, i]
            if val is not None:
                exv[_padx(pos)] = val[:, i]
        assert np.array_equal(np.sort(np.concatenate(seen)), np.arange(cp))
        key = ex[_padx(p)]
        if val is not None:
            val = exv[_padx(p)]
    omask = dmask if unflip else dmask ^ np.uint32(0x80000000)
    out = ex[_padx(np.arange(C))] ^ omask
    return out, (None if val is None else exv[_padx(np.arange(C))])


def _model(keys, vals, P, log2c, alternate, invert, unflip, bits):
    """The kernel's launch: every chunk of P keys (the rest of `keys`
    past its end the pad) as int32 bit patterns, payloads beside."""
    C = 1 << log2c
    ks, vs = [], []
    for c in range(P // C):
        desc = bool(alternate and c & 1) != invert
        k, v = _block(keys, vals, c, C, keys.shape[0], desc, unflip, bits)
        ks.append(k)
        vs.append(v)
    k = np.concatenate(ks).view(np.int32)
    return k, (None if vals is None else np.concatenate(vs))


def _plain(keys, vals, P, log2c, alternate, invert, unflip):
    kw = dict(log2c=log2c, alternate=alternate, invert=invert, unflip=unflip,
              P=P)
    xk = torch.from_numpy(keys.view(np.int32))
    if vals is None:
        return sm._chunk_sort_torch(xk, 0, -(-P // 128), **kw) \
            .reshape(-1)[:P].numpy(), None
    bk, bv = kv._chunk_sort_kv_torch(xk, torch.from_numpy(vals), 0,
                                     -(-P // 128), **kw)
    return bk.reshape(-1)[:P].numpy(), bv.reshape(-1)[:P].numpy()


DIRECTIONS = [(True, False, False), (True, True, True), (False, True, False),
              (False, False, True)]


@pytest.mark.parametrize("bits", [4, 5, 6])
@pytest.mark.parametrize("kind", CHUNK_KEY_KINDS)
def test_model_equals_stable_sort(kind, bits):
    """The model's keys and payloads equal the stable plain versions' for
    every direction case, on three chunks of 2^11 keys (two warps: the
    scan runs over warps), the last chunk short."""
    log2c, P = 11, 3 << 11
    keys = chunk_keys(kind, P - 100, bits, seed=bits)
    vals = np.arange(P - 100, dtype=np.int32) * 7 - 1000
    for alternate, invert, unflip in DIRECTIONS:
        args = (P, log2c, alternate, invert, unflip)
        gk, gv = _model(keys, vals, *args, bits)
        wk, wv = _plain(keys, vals, *args)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv, wv)
        gk, _ = _model(keys, None, *args, bits)
        np.testing.assert_array_equal(gk, _plain(keys, None, *args)[0])


@pytest.mark.parametrize("log2c", [1, 3, 5, 8, 10, 11, 13, 14])
@pytest.mark.parametrize("kind", ["sign_neighbours", "one_digit", "random"])
def test_model_sizes(kind, log2c):
    """Chunks smaller than a warp's items (positions past C hold the
    0xFFFFFFFF fill) up to 16 warps, at the kernel's digit width."""
    bits = sm.RADIX_BITS
    P = 2 << log2c
    keys = chunk_keys(kind, P, bits, seed=log2c)
    keys[:3] = FULL            # real keys equal to the fill sort before it
    vals = np.arange(P, dtype=np.int32)
    for alternate, invert, unflip in DIRECTIONS[:2]:
        args = (P, log2c, alternate, invert, unflip)
        gk, gv = _model(keys, vals, *args, bits)
        wk, wv = _plain(keys, vals, *args)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv, wv)


def test_chunk_limits():
    """The model's keys a thread are the kernel's; the kernel's chunk
    limit (2^14, 512 threads) bounds the modules' LOG2C_KERNEL, which
    stays below the reference's chunk (2^16 keys, 2^15 kv) so the staged
    path runs; the digit width is one of the kernel's instances and one
    setting for both sorts."""
    src = SOURCE.read_text()
    assert re.search(r"constexpr int ITEMS = (\d+);", src).group(1) == \
        str(ITEMS)
    max_log2c = int(re.search(r"constexpr int MAX_LOG2C = (\d+);",
                              src).group(1))
    assert max_log2c == 14 and (1 << max_log2c) // ITEMS == 512
    assert 1 <= sm.LOG2C_KERNEL <= max_log2c
    assert 1 <= kv.LOG2C_KERNEL <= max_log2c
    assert sm.LOG2C_KERNEL < sm.DEFAULT_LOG2C
    assert kv.LOG2C_KERNEL < kv.DEFAULT_LOG2C
    assert sm.RADIX_BITS in (4, 5, 6)
    assert not hasattr(kv, "RADIX_BITS")
