"""The port's radix sort module and histogram (libhpc_tpu_torch/ops/sort.py,
ops/histogram.py) against libhpc_tpu/ops/sort.py and ops/histogram.py (CPU).

The inputs and oracles are those of tests/test_sort.py and
tests/test_histogram_transpose.py: the same numpy arrays go to both
packages, and every result (integer arrays) must be equal exactly, to the
reference's and to the numpy oracle (np.sort, np.bincount, the stage-wise
CPU references).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import EDGE_SIZES
from libhpc_tpu.ops import histogram as ref_hist
from libhpc_tpu.ops import sort as ref_srt
from libhpc_tpu_torch.ops import histogram as hist
from libhpc_tpu_torch.ops import sort as srt


def _u32(rng, n):
    return rng.integers(0, 1 << 32, size=n, dtype=np.uint32)


def _same(got, ref_out):
    """Port result equals the reference's exactly (dtype kind and values)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(ref_out)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return got


# ---- sort_u32 / radix_sort / argsort_u32 / is_sorted -----------------------

@pytest.mark.parametrize("n", EDGE_SIZES)
def test_sort_u32(rng, n):
    x = _u32(rng, n)
    got = _same(srt.sort_u32(x, device="cpu"),
                ref_srt.sort_u32(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x))
    assert bool(srt.is_sorted(torch.from_numpy(got)))
    assert srt.radix_sort is srt.sort_u32
    # int32 bit patterns and int64 values are taken mod 2^32
    np.testing.assert_array_equal(
        srt.sort_u32(torch.from_numpy(x.view(np.int32))).numpy(), got)
    np.testing.assert_array_equal(
        srt.sort_u32(torch.from_numpy(x.astype(np.int64))).numpy(), got)


def test_argsort_stable(rng):
    x = rng.integers(0, 4, size=1000).astype(np.uint32)
    s, order = srt.argsort_u32(torch.from_numpy(x))
    rs, rorder = ref_srt.argsort_u32(jnp.asarray(x))
    _same(s, rs)
    assert order.dtype == torch.int32
    # the reference's sort is stable too, so the orders are the same
    np.testing.assert_array_equal(order.numpy(), np.asarray(rorder))
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(x, kind="stable"))


@pytest.mark.parametrize("x,want", [
    ([], True), ([5], True), ([1, 2, 2, 3], True), ([2, 1], False),
    ([0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], True),
    ([0xFFFFFFFF, 0], False)])
def test_is_sorted(x, want):
    x = np.asarray(x, np.uint32)
    assert bool(srt.is_sorted(torch.from_numpy(x))) is want
    assert bool(srt.is_sorted(x, device="cpu")) is want
    if x.size:
        assert bool(ref_srt.is_sorted(jnp.asarray(x))) is want


# ---- radix pipeline, stage by stage (tests/test_sort.py oracles) ----------

def cpu_local_count(digits, n_bins, tile):
    n_tiles = max(1, -(-len(digits) // tile))
    out = np.zeros((n_tiles, n_bins), np.int32)
    np.add.at(out, (np.arange(len(digits)) // tile, digits), 1)
    return out


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
@pytest.mark.parametrize("n", [1, 111, 500, 3987, 100000])
def test_radix_stages(rng, n, shift):
    """digit_of, tile_histograms, global_base_from_local and
    tile_offsets_from_local against the reference and the CPU oracles."""
    x = _u32(rng, n)
    digits = _same(srt.digit_of(x, shift, device="cpu"),
                   ref_srt.digit_of(jnp.asarray(x), jnp.uint32(shift)))
    np.testing.assert_array_equal(digits, (x >> shift) & 0xFF)
    local = srt.tile_histograms(torch.from_numpy(digits), tile=2048)
    ref_local = ref_srt.tile_histograms(jnp.asarray(digits), tile=2048)
    _same(local, ref_local)
    local_np = cpu_local_count(digits, 256, 2048)
    np.testing.assert_array_equal(local.numpy(), local_np)
    totals = local_np.sum(axis=0)
    np.testing.assert_array_equal(
        _same(srt.global_base_from_local(local),
              ref_srt.global_base_from_local(ref_local)),
        np.cumsum(totals) - totals)
    np.testing.assert_array_equal(
        _same(srt.tile_offsets_from_local(local),
              ref_srt.tile_offsets_from_local(ref_local)),
        np.cumsum(local_np, axis=0) - local_np)


@pytest.mark.parametrize("bits,shift", [(11, 22), (11, 11), (7, 28),
                                        (16, 16)])
def test_digit_of_high_bits(rng, bits, shift):
    """Digits that reach bit 31 need a logical shift."""
    x = _u32(rng, 4000)
    x[:4] = [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0]
    got = _same(srt.digit_of(torch.from_numpy(x), shift, bits),
                ref_srt.digit_of(jnp.asarray(x), jnp.uint32(shift), bits))
    np.testing.assert_array_equal(got, (x >> shift) & ((1 << bits) - 1))


@pytest.mark.parametrize("digits,n_bins,tile", [
    ([3, 1, 3, 3, 1, 0, 2, 2], 4, 4),      # tests/test_sort.py:65-70
    ("random", 256, 2048), ("random", 16, 100)])
def test_rank_within_tiles(rng, monkeypatch, digits, n_bins, tile):
    if digits == "random":
        digits = rng.integers(0, n_bins, size=9000)
        monkeypatch.setattr(srt, "RANK_BATCH_ELEMS", 3 * tile * n_bins)
    d = np.asarray(digits, np.int32)
    got = _same(srt._rank_within_tiles(torch.from_numpy(d), n_bins=n_bins,
                                       tile=tile),
                ref_srt._rank_within_tiles(jnp.asarray(d), n_bins=n_bins,
                                           tile=tile))
    want = np.zeros_like(d)
    for t0 in range(0, d.size, tile):
        seen = {}
        for i in range(t0, min(t0 + tile, d.size)):
            want[i] = seen.get(d[i], 0)
            seen[d[i]] = want[i] + 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 111, 256, 297, 500, 512, 3987, 50000])
def test_radix_pipeline(rng, n):
    x = _u32(rng, n)
    got = _same(srt.radix_sort_pipeline(x, device="cpu"),
                ref_srt.radix_sort_pipeline(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x))


@pytest.mark.parametrize("bits_per_pass,tile", [(8, 2048), (11, 512)])
def test_radix_pipeline_extremes(bits_per_pass, tile):
    x = np.array([0, 0xFFFFFFFF, 1, 0xFFFFFFFE, 0, 7, 0x80000000,
                  0x7FFFFFFF], np.uint32)
    got = srt.radix_sort_pipeline(torch.from_numpy(x), bits_per_pass, tile)
    np.testing.assert_array_equal(got.numpy(), np.sort(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_srt.radix_sort_pipeline(
            jnp.asarray(x), bits_per_pass=bits_per_pass, tile=tile)))


@pytest.mark.parametrize("n", [1, 2, 111, 256, 1024, 3987, 8192])
def test_bitonic_sort(rng, n):
    x = _u32(rng, n)
    got = _same(srt.bitonic_sort(x, device="cpu"),
                ref_srt.bitonic_sort(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x))


def test_bitonic_extremes():
    x = np.array([0xFFFFFFFF, 0, 0xFFFFFFFF, 5, 0, 0x80000000], np.uint32)
    got = _same(srt.bitonic_sort(torch.from_numpy(x)),
                ref_srt.bitonic_sort(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x))


# ---- histogram (tests/test_histogram_transpose.py) -------------------------

@pytest.mark.parametrize("n", EDGE_SIZES)
def test_histogram(rng, n):
    """histogram and histogram_pallas (K15's plain version on the CPU):
    padding not counted, totals exactly n."""
    x = rng.integers(0, 256, size=n).astype(np.int32)
    want = np.bincount(x, minlength=256)
    xt = torch.from_numpy(x)
    got = _same(hist.histogram(xt, 256), ref_hist.histogram(jnp.asarray(x),
                                                            256))
    np.testing.assert_array_equal(got, want)
    got = _same(hist.histogram_pallas(xt, 256),
                ref_hist.histogram_pallas(jnp.asarray(x), 256))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == n
    np.testing.assert_array_equal(hist.histogram_pallas_torch(xt).numpy(),
                                  want)


def test_histogram_out_of_range():
    """Values outside [0, n_bins) (the reference's padding bin n_bins,
    negatives, larger values) are not counted."""
    x = np.array([0, 3, 3, 16, -1, 15, 1000, 16, 2**31 - 1, -2**31],
                 np.int32)
    want = np.bincount(x[(x >= 0) & (x < 16)], minlength=16)
    for fn, ref_fn in [(hist.histogram, ref_hist.histogram),
                       (hist.histogram_pallas, ref_hist.histogram_pallas)]:
        got = _same(fn(torch.from_numpy(x), 16), ref_fn(jnp.asarray(x), 16))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,n_bins,tile", [(1, 16, 256), (111, 16, 256),
                                           (3987, 16, 256),
                                           (5000, 256, 1024)])
def test_local_histogram(rng, n, n_bins, tile):
    x = rng.integers(0, n_bins, size=n).astype(np.int32)
    got = _same(hist.local_histogram(torch.from_numpy(x), n_bins, tile=tile),
                ref_hist.local_histogram(jnp.asarray(x), n_bins, tile=tile))
    n_tiles = max(1, -(-n // tile))
    assert got.shape == (n_tiles, n_bins)
    for t in range(n_tiles):
        seg = x[t * tile:(t + 1) * tile]
        np.testing.assert_array_equal(got[t], np.bincount(seg,
                                                          minlength=n_bins))
    assert got.sum() == n  # padding not counted
