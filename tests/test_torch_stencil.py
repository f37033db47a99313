"""The port's stencils (libhpc_tpu_torch/ops/stencil.py) and HaloArray
(libhpc_tpu_torch/containers.py) against libhpc_tpu/ops/stencil.py and
libhpc_tpu/containers.py (CPU; the reference's Pallas blur in interpret
mode, the port's plain versions).

Shapes and tolerances are tests/test_stencil.py's and
tests/test_halo_array.py's: 1-D blurs rtol/atol 1e-4, 2-D blurs 1e-3 (the
reference's x cumsum spans a whole padded row, so it rounds differently
from the port's direct sums), the Poisson operators 1e-4 against CSR; a
float64 box sum is the oracle besides the reference. HaloArray results are
equal exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhpc_tpu.containers import HaloArray as RefHalo
from libhpc_tpu.ops import stencil as ref
from libhpc_tpu_torch.bench import matrices
from libhpc_tpu_torch.containers import HaloArray
from libhpc_tpu_torch.ops import stencil

from _torch_port import assert_same_container, port_of

TOL1 = dict(rtol=1e-4, atol=1e-4)
TOL2 = dict(rtol=1e-3, atol=1e-3)


def naive_blur_x(a, r):
    m, n = a.shape
    ap = np.pad(a.astype(np.float64), ((0, 0), (r, r)))
    out = np.zeros((m, n))
    for dx in range(2 * r + 1):
        out += ap[:, dx: dx + n]
    return out


def naive_blur_y(a, r):
    return naive_blur_x(a.T, r).T


@pytest.mark.parametrize("shape,r", [((1, 1), 1), ((17, 33), 2),
                                     ((64, 64), 8), ((111, 297), 8)])
def test_blur_x(rng, shape, r):
    a = rng.random(shape).astype(np.float32)
    got = stencil.blur_x(a, r, device="cpu").numpy()
    np.testing.assert_allclose(got, naive_blur_x(a, r), **TOL1)
    np.testing.assert_allclose(
        got, np.asarray(ref.blur_x(jnp.asarray(a), r)), **TOL1)


@pytest.mark.parametrize("shape,r", [((17, 33), 2), ((64, 64), 8)])
def test_blur_y(rng, shape, r):
    a = rng.random(shape).astype(np.float32)
    got = stencil.blur_y(torch.from_numpy(a), r).numpy()
    np.testing.assert_allclose(got, naive_blur_y(a, r), **TOL1)
    np.testing.assert_allclose(
        got, np.asarray(ref.blur_y(jnp.asarray(a), r)), **TOL1)


@pytest.mark.parametrize("shape,r", [((64, 64), 8), ((100, 200), 4)])
def test_blur2d(rng, shape, r):
    a = rng.random(shape).astype(np.float32)
    got = stencil.blur2d(a, r, device="cpu").numpy()
    np.testing.assert_allclose(got, naive_blur_y(naive_blur_x(a, r), r),
                               **TOL2)
    np.testing.assert_allclose(
        got, np.asarray(ref.blur2d(jnp.asarray(a), r)), **TOL2)


@pytest.mark.parametrize("shape,r,tile_m", [((64, 64), 8, 32),
                                            ((100, 200), 4, 32),
                                            ((300, 129), 8, 64),
                                            ((5, 7), 3, None)])
def test_blur2d_pallas(rng, shape, r, tile_m):
    a = rng.random(shape).astype(np.float32)
    got = stencil.blur2d_pallas(a, r, tile_m=tile_m, device="cpu")
    assert got.dtype == torch.float32 and got.shape == shape
    got = got.numpy()
    np.testing.assert_allclose(got, naive_blur_y(naive_blur_x(a, r), r),
                               **TOL2)
    want = np.asarray(ref.blur2d_pallas(jnp.asarray(a), r, tile_m=tile_m))
    np.testing.assert_allclose(got, want, **TOL2)


def test_blur2d_pallas_plain_matches_float64_box_sum(rng):
    """The plain version adds 2r + 1 terms per pass, so it stays within a
    few float32 roundings of the exact box sum, at any width."""
    a = rng.random((40, 3000)).astype(np.float32)
    got = stencil.blur2d_pallas_torch(torch.from_numpy(a), 8).numpy()
    exact = naive_blur_y(naive_blur_x(a, 8), 8)
    np.testing.assert_allclose(got, exact, rtol=1e-5)


def test_poisson5_matches_csr(rng):
    n = 24
    A = matrices.poisson2d(n)
    u = rng.random((n, n)).astype(np.float32)
    got = stencil.poisson5_apply(u, device="cpu").numpy()
    np.testing.assert_allclose(got, (A @ u.ravel()).reshape(n, n), **TOL1)
    np.testing.assert_allclose(
        got, np.asarray(ref.poisson5_apply(jnp.asarray(u))), **TOL1)


def test_poisson7_matches_csr(rng):
    n = 10
    A = matrices.poisson3d(n)
    u = rng.random((n, n, n)).astype(np.float32)
    got = stencil.poisson7_apply(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, (A @ u.ravel()).reshape(n, n, n), **TOL1)
    np.testing.assert_allclose(
        got, np.asarray(ref.poisson7_apply(jnp.asarray(u))), **TOL1)


def test_kernel_wrapper_on_cpu_is_the_plain_version(rng, monkeypatch):
    monkeypatch.setattr(stencil, "BLUR_LAUNCHES", 0)
    a = torch.from_numpy(rng.random((70, 90)).astype(np.float32))
    assert torch.equal(stencil.blur2d_pallas(a, 5),
                       stencil.blur2d_pallas_torch(a, 5))
    with pytest.raises(ValueError):
        stencil.blur2d_pallas(a[0])
    assert stencil.BLUR_LAUNCHES == 0


# ---- HaloArray (tests/test_halo_array.py against the reference) -----------


def _both(x, lo, hi=None, fill=0):
    return (HaloArray.wrap(x, lo, hi, fill, device="cpu"),
            RefHalo.wrap(jnp.asarray(x), lo, hi, fill))


def test_wrap_and_interior(rng):
    x = rng.random((6, 10)).astype(np.float32)
    h, r = _both(x, (2, 3), (1, 0), 7.0)
    assert_same_container(h, r)
    assert h.data.shape == (9, 13) and h.interior_shape == (6, 10)
    np.testing.assert_array_equal(h.interior.numpy(), x)
    assert float(h.data[0, 5]) == 7.0 and float(h.data[-1, 5]) == 7.0


def test_negative_index_window(rng):
    x = rng.random((4, 8)).astype(np.float32)
    h, r = _both(x, 2, fill=-1.0)
    w = h.window((-2, 0), (3, 8)).numpy()
    np.testing.assert_array_equal(w, np.asarray(r.window((-2, 0), (3, 8))))
    assert np.all(w[:2] == -1.0)
    np.testing.assert_array_equal(w[2], x[0])


def test_shift_is_stencil_access(rng):
    x = rng.random((5, 7)).astype(np.float32)
    h, r = _both(x, 1)
    for off in ((-1, 0), (1, 0), (0, -1), (0, 1), (1, 1)):
        np.testing.assert_array_equal(h.shift(off).numpy(),
                                      np.asarray(r.shift(off)))
    up = h.shift((-1, 0)).numpy()
    np.testing.assert_array_equal(up[1:], x[:-1])
    assert np.all(up[0] == 0.0)


def test_checked_bounds():
    h = HaloArray.wrap(torch.zeros((4, 4)), 1)
    with pytest.raises(IndexError):
        h.window((-2, 0), (4, 4))
    with pytest.raises(IndexError):
        h.shift((0, 2))
    with pytest.raises(ValueError):
        HaloArray.wrap(torch.zeros((4, 4)), (1, 1, 1))


def test_with_interior_keeps_ghosts(rng):
    x = rng.random((3, 3)).astype(np.float32)
    h, r = _both(x, 1, fill=5.0)
    h2 = h.with_interior(torch.zeros((3, 3)))
    assert_same_container(h2, r.with_interior(jnp.zeros((3, 3), jnp.float32)))
    assert float(h2.data[0, 0]) == 5.0
    assert np.all(h2.interior.numpy() == 0.0)
    np.testing.assert_array_equal(h.interior.numpy(), x)  # h unchanged
    with pytest.raises(ValueError):
        h.with_interior(torch.zeros((2, 3)))


def test_set_halo_slab(rng):
    x = rng.random((4, 6)).astype(np.float32)
    h, r = _both(x, (1, 0))
    g = np.full((1, 6), 9.0, np.float32)
    h2 = h.set_halo(0, "lo", torch.from_numpy(g)).set_halo(
        0, "hi", torch.from_numpy(g * 2))
    r2 = r.set_halo(0, "lo", jnp.asarray(g)).set_halo(0, "hi",
                                                      jnp.asarray(g * 2))
    assert_same_container(h2, r2)
    assert np.all(h2.data[0].numpy() == 9.0)
    assert np.all(h2.data[-1].numpy() == 18.0)
    assert h.set_halo(1, "lo", torch.zeros(4)) is h   # zero-width slab


def test_from_padded_and_carried_halo(rng):
    """A reference HaloArray carried into the port (its leaves and static
    lo/hi) computes the same stencils there."""
    x = rng.random((9, 11)).astype(np.float32)
    r = RefHalo.from_padded(jnp.asarray(x), (1, 1), (1, 1))
    h = port_of(r)
    assert_same_container(h, r)
    assert h.interior_shape == r.interior_shape == (7, 9)
    np.testing.assert_allclose(stencil.poisson5_halo(h).numpy(),
                               np.asarray(ref.poisson5_halo(r)), rtol=1e-6)
    hb = HaloArray.from_padded(x, 3, device="cpu")
    rb = RefHalo.from_padded(jnp.asarray(x), 3)
    for axis in (0, 1):
        hh = HaloArray.wrap(hb.interior, (4, 4), (3, 3))
        rr = RefHalo.wrap(rb.interior, (4, 4), (3, 3))
        np.testing.assert_allclose(stencil.box_sum_halo(hh, 3, axis).numpy(),
                                   np.asarray(ref.box_sum_halo(rr, 3, axis)),
                                   **TOL1)


def test_shared_kernel_zero_vs_filled_halo(rng):
    x = rng.random((6, 6)).astype(np.float32)
    h0, r0 = _both(x, 1)
    y0 = stencil.poisson5_halo(h0).numpy()
    np.testing.assert_allclose(y0, np.asarray(ref.poisson5_halo(r0)),
                               rtol=1e-6)
    h1 = h0.set_halo(0, "lo", torch.ones((1, 8)))
    y1 = stencil.poisson5_halo(h1).numpy()
    np.testing.assert_allclose(y1[1:], y0[1:], rtol=1e-6)
    np.testing.assert_allclose(y1[0], y0[0] - 1.0, rtol=1e-5)
