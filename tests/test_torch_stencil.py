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

import pathlib
import re

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


ALIGNED = 1 << 40   # a data_ptr on a 16-byte boundary
BLUR_SOURCE = (pathlib.Path(stencil.__file__).resolve().parents[1] / "csrc"
               / "blur2d.cu")


def blur_layout(r):
    """csrc/blur2d.cu's constants, and its box width and shared memory of a
    block at radius r, evaluated from the source's own expressions."""
    src = BLUR_SOURCE.read_text()
    c = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
         for k in ("TN", "S", "NST", "MAX_RADIUS", "MAX_BOX", "MAX_SMEM")}
    box = re.search(r"constexpr int box_width\(int r\) \{ return ([^;]+);",
                    src).group(1)
    smem = re.search(r"constexpr int smem_bytes\(int r, int box_w\) \{\s*"
                     r"return ([^;]+);", src).group(1)
    c["box_w"] = eval(box.replace("/", "//"), {}, {**c, "r": r})
    c["smem"] = eval(smem, {}, {**c, "r": r})
    return c


def test_blur_plan_takes_tma_at_8192():
    """The main path's 8192^2, r = 8 input, aligned: TMA, bands of 256
    rows, a box of 144 columns, two blocks an SM (each block also costs
    the SM 1 KB)."""
    p = stencil.blur_plan(8192, 8192, 8, ALIGNED)
    assert p.mode == "tma" and p.band_rows == 256
    k = blur_layout(8)
    assert k["box_w"] == 144 and k["smem"] == 96_408
    assert 2 * (k["smem"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("m,n,ptr", [(8192, 8191, ALIGNED),
                                     (8191, 8191, ALIGNED),
                                     (8192, 8190, ALIGNED),
                                     (8192, 8192, ALIGNED + 4),
                                     (8192, 8192, ALIGNED + 8),
                                     (2 ** 31 - 64, 4, ALIGNED)])
def test_blur_plan_takes_plain_loads(m, n, ptr):
    """n % 4 != 0 (the tensor map's row stride), a pointer off a 16-byte
    boundary, or a box row coordinate past int32 take the plain loads."""
    assert stencil.blur_plan(m, n, 8, ptr).mode == "plain"
    assert stencil.blur_plan(2 ** 31 - 65, 4, 8, ALIGNED).mode == "tma"


@pytest.mark.parametrize("r", range(stencil.MAX_KERNEL_RADIUS + 1))
def test_blur_plan_fits_every_radius(r):
    """Every radius the kernel takes: the box holds 128 + 2r columns in a
    multiple of 4 floats and at most 256 (a TMA box), and a block's shared
    memory fits the H100's 232,448 bytes; radii past 8 walk longer
    bands."""
    p = stencil.blur_plan(8192, 8192, r, ALIGNED)
    assert p.band_rows == (256 if r <= 8 else 1024)
    k = blur_layout(r)
    assert k["MAX_RADIUS"] == stencil.MAX_KERNEL_RADIUS
    assert k["MAX_BOX"] == 256 and k["MAX_SMEM"] == 232_448
    assert k["TN"] + 2 * r <= k["box_w"] <= 256 and k["box_w"] % 4 == 0
    assert k["box_w"] - (k["TN"] + 2 * r) < 4
    assert k["smem"] <= 232_448


def test_blur_launch_counters_stay_on_cpu(rng, monkeypatch):
    """CPU tensors take the plain version in every load mode the plan
    would pick: no counter moves."""
    for name in ("BLUR_LAUNCHES", "BLUR_TMA_LAUNCHES", "BLUR_PLAIN_LAUNCHES"):
        monkeypatch.setattr(stencil, name, 0)
    for shape in ((64, 64), (65, 63)):
        a = torch.from_numpy(rng.random(shape).astype(np.float32))
        assert torch.equal(stencil.blur2d_pallas(a, 3),
                           stencil.blur2d_pallas_torch(a, 3))
    assert (stencil.BLUR_LAUNCHES, stencil.BLUR_TMA_LAUNCHES,
            stencil.BLUR_PLAIN_LAUNCHES) == (0, 0, 0)


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


def test_poisson_stencils_of_bool_match_the_reference():
    """The reference's float coefficients promote bool to float32: 4 on
    the diagonal of eye(4) and -2 beside it; 6 at the centre of a 3^3
    cube and -1 at its faces."""
    a = np.eye(4, dtype=bool)
    got = stencil.poisson5_apply(a, device="cpu").numpy()
    want = np.asarray(ref.poisson5_apply(jnp.asarray(a)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diag(got) == 4) and np.all(np.diag(got, 1) == -2)
    u = np.zeros((3, 3, 3), bool)
    u[1, 1, 1] = True
    got = stencil.poisson7_apply(u, device="cpu").numpy()
    want = np.asarray(ref.poisson7_apply(jnp.asarray(u)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got[1, 1, 1] == 6 and got[0, 1, 1] == got[1, 2, 1] == -1


@pytest.mark.parametrize("dtype", [np.int32, np.int8, np.uint8, np.int16])
def test_cumsum_stencils_keep_integer_dtypes(rng, dtype):
    """jnp.cumsum keeps an integer dtype (sums wrap), so the cumsum-form
    blurs return the input's dtype with the reference's values."""
    a = rng.integers(0, 100, (8, 8)).astype(dtype)
    got = stencil.blur2d(a, 2, device="cpu").numpy()
    want = np.asarray(ref.blur2d(jnp.asarray(a), 2))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    got_x = stencil.blur_x(torch.from_numpy(a), 2).numpy()
    want_x = np.asarray(ref.blur_x(jnp.asarray(a), 2))
    assert got_x.dtype == want_x.dtype
    np.testing.assert_array_equal(got_x, want_x)
