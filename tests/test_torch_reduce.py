"""The port's reductions (libhpc_tpu_torch/ops/reduce.py) against
libhpc_tpu/ops/reduce.py (CPU; the reference's Pallas row-sum kernel in
interpret mode, the port's plain torch versions).

Shapes and tolerances are tests/test_scan_reduce.py's: row sums rtol 1e-4,
atol 1e-5 (float32, summed in another order); the tree reduce of int32
exactly; segment sums rtol 1e-4, segment max/min exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import EDGE_SIZES
from libhpc_tpu.ops import reduce as ref
from libhpc_tpu_torch.ops import reduce as red

ROW_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 1), (8, 128), (100, 300), (257, 129)])
def test_row_sum_pallas(rng, shape):
    x = rng.random(shape).astype(np.float32)
    got = red.row_sum_pallas(x, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    want = np.asarray(ref.row_sum_pallas(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, **ROW_TOL)
    np.testing.assert_allclose(got.numpy(), x.sum(axis=1), **ROW_TOL)


def test_row_sum_pallas_int32_wraps():
    """int32 rows sum in int32 and wrap past 2^31, as the reference's
    jnp.sum does."""
    x = np.full((3, 5), 2**30, np.int32)
    x[1] = np.arange(5)
    got = red.row_sum_pallas(torch.from_numpy(x))
    assert got.dtype == torch.int32
    want = np.asarray(ref.row_sum_pallas(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [2**30, 10, 2**30]


def test_row_sum_pallas_bf16(rng):
    """bfloat16 rows: summed in float32, returned in bfloat16; against the
    reference's bfloat16 row sum to one bfloat16 rounding (rtol 8e-3)."""
    x = rng.random((37, 300)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = red.row_sum_pallas(xb)
    assert got.dtype == torch.bfloat16
    want_ref = ref.row_sum_pallas(jnp.asarray(x, jnp.bfloat16))
    assert want_ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want_ref.astype(jnp.float32)),
                               rtol=8e-3, atol=0)
    want = xb.float().sum(dim=1)
    torch.testing.assert_close(got.float(), want, rtol=8e-3, atol=0)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_tree_reduce(rng, n):
    x = rng.integers(0, 100, size=n).astype(np.int32)
    got = red.tree_reduce_sum(x, device="cpu")
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(ref.tree_reduce_sum(jnp.asarray(x)))
    assert int(got) == int(x.astype(np.int64).sum())


def test_tree_reduce_f32(rng):
    x = rng.random(1024 * 256 + 57).astype(np.float32)
    got = float(red.tree_reduce_sum(torch.from_numpy(x)))
    np.testing.assert_allclose(got, float(ref.tree_reduce_sum(jnp.asarray(x))),
                               rtol=1e-5)
    np.testing.assert_allclose(got, x.astype(np.float64).sum(), rtol=1e-5)


def test_segment_ops(rng):
    ids = rng.integers(0, 10, size=1000).astype(np.int32)
    x = rng.random(1000).astype(np.float32)
    got = red.segment_sum(x, ids, 10, device="cpu").numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref.segment_sum(jnp.asarray(x), jnp.asarray(ids), 10)),
        rtol=1e-4)
    expect = np.array([x[ids == i].sum() for i in range(10)], np.float32)
    np.testing.assert_allclose(got, expect, rtol=1e-4)
    for f in ("segment_max", "segment_min"):
        got = getattr(red, f)(x, ids, 10, device="cpu").numpy()
        want = np.asarray(getattr(ref, f)(jnp.asarray(x), jnp.asarray(ids), 10))
        np.testing.assert_array_equal(got, want)
    gmax = red.segment_max(x, ids, 10, device="cpu").numpy()
    for i in range(10):
        assert gmax[i] == x[ids == i].max()


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_ops_empty_and_dropped_segments(rng, dtype):
    """Empty segments hold the identity (0, lowest, highest); ids outside
    [0, num_segments) are dropped — as jax.ops.segment_* do."""
    ids = np.array([0, 0, 2, 7, 9, 3], np.int32)
    x = (rng.random((6, 3)) * 100).astype(dtype)
    for f in ("segment_sum", "segment_max", "segment_min"):
        got = getattr(red, f)(torch.from_numpy(x), torch.from_numpy(ids), 5)
        want = np.asarray(getattr(ref, f)(jnp.asarray(x), jnp.asarray(ids), 5))
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_segment_max_min_of_bool_match_the_reference():
    """bool data: an empty segment holds the identity (False for max, True
    for min) and ids outside [0, num_segments) are dropped."""
    x = np.array([1, 0, 1, 1, 1, 1, 0], bool)
    ids = np.array([0, 2, 2, 5, -1, 7, 1], np.int32)
    for f, expect in (("segment_max", [1, 0, 1, 0, 0, 1]),
                      ("segment_min", [1, 0, 0, 1, 1, 1])):
        got = getattr(red, f)(x, ids, 6, device="cpu").numpy()
        want = np.asarray(getattr(ref, f)(jnp.asarray(x), jnp.asarray(ids),
                                          6))
        assert got.dtype == want.dtype == np.bool_
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.array(expect, bool))


def test_kernel_wrapper_on_cpu_is_the_plain_version(rng, monkeypatch):
    monkeypatch.setattr(red, "ROW_SUM_LAUNCHES", 0)
    x = torch.from_numpy(rng.random((50, 70)).astype(np.float32))
    assert torch.equal(red.row_sum_pallas(x), red.row_sum_pallas_torch(x))
    with pytest.raises(ValueError):
        red.row_sum_pallas(x[0])
    assert red.ROW_SUM_LAUNCHES == 0
    assert red.FAN_IN == ref.FAN_IN


@pytest.mark.parametrize("dtype,value", [
    (np.int8, 100), (np.uint8, 200), (np.int16, 200), (np.bool_, True),
    (np.uint16, 60000), (np.uint32, 4_000_000_000), (np.int32, 2**30),
    (np.float16, 1.0)])
def test_tree_reduce_dtype_of_jnp_sum(dtype, value):
    """The sum comes back in jnp.sum's dtype (narrow integers widen to
    int32 or uint32) and wraps at 32 bits as the reference's does."""
    x = np.full(3000, value, dtype)
    got = red.tree_reduce_sum(torch.from_numpy(x))
    want = np.asarray(ref.tree_reduce_sum(jnp.asarray(x)))
    assert got.shape == ()
    assert got.numpy().dtype == want.dtype
    assert got.numpy() == want
