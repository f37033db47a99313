"""The port's compensated reductions (ops/precision.py) against
libhpc_tpu's on the CPU, and against the float64 oracle of the reference's
tests/test_precision.py at that test's bounds.

two_sum and two_prod are bit-equal to the reference on the same float32
inputs (both run op by op, no FMA contraction) and exact against float64;
the compensated sum and dot match the reference's to 1e-6 relative (both
are double-float trees; the reference's runs as one jitted program).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhpc_tpu.ops import precision as ref_pr
from libhpc_tpu_torch.ops import precision as pr

from _torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_two_sum_bit_equal_and_exact(rng):
    a = (rng.standard_normal(1000) * 10.0 ** rng.integers(-8, 9, 1000)) \
        .astype(np.float32)
    b = (rng.standard_normal(1000) * 10.0 ** rng.integers(-8, 9, 1000)) \
        .astype(np.float32)
    s, e = pr.two_sum(_t(a), _t(b))
    rs, re = ref_pr.two_sum(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(e.numpy(), np.asarray(re))
    np.testing.assert_array_equal(
        s.numpy().astype(np.float64) + e.numpy().astype(np.float64),
        a.astype(np.float64) + b.astype(np.float64))
    # the reference test's case
    s1, e1 = pr.two_sum(torch.tensor(1e8), torch.tensor(1.5))
    assert float(s1) + float(e1) == float(np.float64(np.float32(1e8)) + 1.5)


def test_two_prod_bit_equal_and_exact(rng):
    a = rng.random(1000).astype(np.float32) * 1e3
    b = rng.random(1000).astype(np.float32) * 1e-3
    p, e = pr.two_prod(_t(a), _t(b))
    rp, re = ref_pr.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(p.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(e.numpy(), np.asarray(re))
    np.testing.assert_array_equal(
        p.numpy().astype(np.float64) + e.numpy().astype(np.float64),
        a.astype(np.float64) * b.astype(np.float64))


def test_df_add_bit_equal(rng):
    xh, xl, yh, yl = (rng.standard_normal(500).astype(np.float32)
                      * s for s in (1e4, 1e-4, 1e3, 1e-5))
    hi, lo = pr.df_add(_t(xh), _t(xl), _t(yh), _t(yl))
    rh, rl = ref_pr.df_add(*(jnp.asarray(v) for v in (xh, xl, yh, yl)))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rl))


def test_sum_compensated_beats_plain(rng):
    # the reference test's adversarial set: large values cancel, the
    # residue is carried by the small ones
    big = rng.random(50_000).astype(np.float32) * 1e7
    x = np.concatenate([big, -big, rng.random(50_001).astype(np.float32)])
    rng.shuffle(x)
    exact = x.astype(np.float64).sum()
    plain = float(torch.sum(_t(x)))
    comp = float(pr.sum_compensated(_t(x)))
    ref = float(ref_pr.sum_compensated(jnp.asarray(x)))
    assert abs(comp - exact) <= abs(plain - exact)
    assert abs(comp - exact) < 1e-2
    np.testing.assert_allclose(comp, ref, rtol=1e-6)


def test_dot_compensated(rng):
    x = (rng.random(100_001) * 2 - 1).astype(np.float32) * 1e4
    y = (rng.random(100_001) * 2 - 1).astype(np.float32) * 1e-4
    exact = np.dot(x.astype(np.float64), y.astype(np.float64))
    comp = float(pr.dot_compensated(_t(x), _t(y)))
    ref = float(ref_pr.dot_compensated(jnp.asarray(x), jnp.asarray(y)))
    assert abs(comp - exact) / max(abs(exact), 1e-30) < 1e-6
    np.testing.assert_allclose(comp, ref, rtol=1e-6)
    plain = float(torch.dot(_t(x), _t(y)))
    assert abs(comp - exact) <= abs(plain - exact)
    n2 = float(pr.norm2_compensated(_t(x)))
    np.testing.assert_allclose(n2, float(ref_pr.norm2_compensated(
        jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(n2, np.linalg.norm(x.astype(np.float64)),
                               rtol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 1023])
def test_odd_sizes(rng, n):
    x = rng.random(n).astype(np.float32)
    got = pr.sum_compensated(_t(x))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), x.astype(np.float64).sum(),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(got), float(ref_pr.sum_compensated(jnp.asarray(x))),
        rtol=1e-6)
    y = rng.random(n).astype(np.float32)
    np.testing.assert_allclose(float(pr.dot_compensated(_t(x), _t(y))),
                               np.dot(x.astype(np.float64),
                                      y.astype(np.float64)), rtol=1e-6)


def test_inputs_are_flattened_to_float32(rng):
    x = rng.random((33, 5))
    got = pr.sum_compensated(torch.from_numpy(x))      # float64 tensor
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), x.astype(np.float32)
                               .astype(np.float64).sum(), rtol=1e-6)
    np.testing.assert_allclose(
        float(pr.sum_compensated(x, device="cpu")), float(got), rtol=0)
