"""The port's scans (libhpc_tpu_torch/ops/scan.py) against
libhpc_tpu/ops/scan.py (CPU; the reference's Pallas kernels in interpret
mode, the port's plain torch versions).

Sizes are the reference's edge-size sweep (EDGE_SIZES). Integer results
must be equal exactly, dtype included, wraparound past 2^31 included;
float32 results agree with the reference and with a float64 oracle to
rtol/atol 1e-4 (tests/test_scan_reduce.py's tolerance: the two packages
add in different orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import EDGE_SIZES
from libhpc_tpu.ops import scan as ref
from libhpc_tpu_torch.ops import scan

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_exclusive_and_inclusive_scan_int(rng, n):
    x = rng.integers(0, 100, size=n).astype(np.int32)
    for f in ("exclusive_scan", "inclusive_scan"):
        got = getattr(scan, f)(x, device="cpu")
        want = np.asarray(getattr(ref, f)(jnp.asarray(x)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        scan.exclusive_scan(torch.from_numpy(x)).numpy(), np.cumsum(x) - x)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_exclusive_scan_pallas_f32(rng, n):
    x = rng.random(n).astype(np.float32)
    got = scan.exclusive_scan_pallas(x, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    got = got.numpy()
    oracle = (np.cumsum(x.astype(np.float64)) - x).astype(np.float32)
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.exclusive_scan_pallas(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        scan.exclusive_scan(torch.from_numpy(x)).numpy(), oracle, **TOL)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_exclusive_scan_pallas_int(rng, n):
    x = rng.integers(0, 1000, size=n).astype(np.int32)
    got = scan.exclusive_scan_pallas(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.exclusive_scan_pallas(jnp.asarray(x))))
    np.testing.assert_array_equal(got.numpy(), np.cumsum(x) - x)


def test_exclusive_scan_pallas_wraps():
    """Sums past 2^31: int32 adds wrap, in both packages alike."""
    x = np.full(5000, 2**30, np.int32)
    want = np.asarray(ref.exclusive_scan_pallas(jnp.asarray(x)))
    got = scan.exclusive_scan_pallas(x, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[:5]) == [0, 2**30, -2**31, -2**30, 0]
    np.testing.assert_array_equal(
        scan.exclusive_scan(x, device="cpu").numpy(),
        np.asarray(ref.exclusive_scan(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.uint16,
                                   np.uint32])
def test_other_integer_dtypes(dtype):
    """The reference keeps every integer dtype and wraps in it; so does
    the port, through the kernel path's plain version too."""
    x = (np.arange(3000) % 100 + 100).astype(dtype)
    for f in ("exclusive_scan", "inclusive_scan", "exclusive_scan_pallas"):
        got = getattr(scan, f)(x, device="cpu").numpy()
        want = np.asarray(getattr(ref, f)(jnp.asarray(x)))
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)


def test_scans_of_bool_match_the_reference():
    """jnp.cumsum promotes bool to int32; so do the port's scans. The
    kernel path refuses bool, as the reference's does."""
    for x in (np.array([True, False, True, True, False]),
              np.ones((2, 3), bool)):
        for f in ("exclusive_scan", "inclusive_scan"):
            got = getattr(scan, f)(x, device="cpu").numpy()
            want = np.asarray(getattr(ref, f)(jnp.asarray(x)))
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    x = np.array([True, False, True, True, False])
    assert list(scan.exclusive_scan(x, device="cpu")) == [0, 1, 1, 2, 3]
    assert list(scan.inclusive_scan(x, device="cpu")) == [1, 1, 2, 3, 3]
    with pytest.raises(TypeError):
        ref.exclusive_scan_pallas(jnp.asarray(x))
    with pytest.raises(TypeError):
        scan.exclusive_scan_pallas(torch.from_numpy(x))


def test_refused_dtypes_and_shapes():
    for dt in (torch.int64, torch.float64, torch.float16):
        with pytest.raises(TypeError):
            scan.exclusive_scan_pallas(torch.zeros(10, dtype=dt))
    with pytest.raises(ValueError):
        scan.exclusive_scan_pallas(torch.zeros((2, 5)))


def test_scan_along_last_axis(rng):
    x = rng.random((3, 257)).astype(np.float32)
    np.testing.assert_allclose(
        scan.exclusive_scan(x, device="cpu").numpy(),
        np.asarray(ref.exclusive_scan(jnp.asarray(x))), **TOL)


def test_constants_and_scratch():
    assert (scan.SUBLANES, scan.WIDE, scan.TILE, scan.MXU_ROWS) == (
        ref.SUBLANES, ref.WIDE, ref.TILE, ref.MXU_ROWS)
    # the one-pass kernel's tile counter and one status word a tile of 8192
    assert scan.scan_scratch_len(1) == 2
    assert scan.scan_scratch_len(8191) == 2
    assert scan.scan_scratch_len(8192) == 2
    assert scan.scan_scratch_len(8193) == 3
    assert scan.scan_scratch_len(3 * 8192) == 4
    assert scan.scan_scratch_len(500_000_000) == 61_036 + 1


def test_kernel_wrappers_on_cpu_are_the_plain_versions(rng):
    x = rng.random(10_000).astype(np.float32)
    xt = torch.from_numpy(x)
    assert torch.equal(scan._exclusive_scan_f32(xt),
                       scan._exclusive_scan_f32_torch(xt))
    xi = torch.from_numpy(rng.integers(-5, 5, 10_000).astype(np.int32))
    assert torch.equal(scan._exclusive_scan_int(xi),
                       scan._exclusive_scan_int_torch(xi))
    assert scan._exclusive_scan_f32_torch(xt[:0]).shape == (0,)
