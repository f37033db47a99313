"""The port's sparse grids (libhpc_tpu_torch/sparse/grid.py) and Morton codes
(libhpc_tpu_torch/utils/morton.py) against libhpc_tpu/sparse/grid.py and
libhpc_tpu/utils/morton.py (CPU, plain torch on both sides of the port).

The cases are tests/test_grid.py's and tests/test_morton.py's. Morton codes,
slot maps, the slot -> tile map and the allocation cursors must be equal
exactly; values are held against the reference's and a dense numpy
scatter-add oracle at rtol/atol 1e-4 (float sums of duplicate writes may
add in another order), and exactly where the written values are small
integers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhpc_tpu.sparse.grid import BlockGrid as RefGrid
from libhpc_tpu.sparse.grid import NestedGrid as RefNested
from libhpc_tpu.utils import morton as ref_morton
from libhpc_tpu_torch.sparse.grid import BlockGrid, NestedGrid
from libhpc_tpu_torch.utils.morton import (morton2d_decode, morton2d_encode,
                                           morton3d_decode, morton3d_encode)

from _torch_port import assert_same_container, port_of

TOL = dict(rtol=1e-4, atol=1e-4)
VALUE_LEAVES = ("tiles", "leaves")


def _same_grid(port, ref, exact=False):
    """Slot maps and cursors exactly; values exactly or to TOL."""
    assert type(port).__name__ == type(ref).__name__
    got = port.to_numpy()
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.metadata.get("static"):
            assert getattr(port, f.name) == v, f.name
            continue
        want = np.asarray(v)
        assert got[f.name].dtype == want.dtype, f.name
        assert got[f.name].shape == want.shape, f.name
        if f.name in VALUE_LEAVES and not exact:
            np.testing.assert_allclose(got[f.name], want, err_msg=f.name,
                                       **TOL)
        else:
            np.testing.assert_array_equal(got[f.name], want, err_msg=f.name)


def _pair(shape, **kw):
    return (BlockGrid.create(shape, device="cpu", **kw),
            RefGrid.create(shape, **kw))


def _xy(xs, ys):
    xs, ys = np.asarray(xs, np.int32), np.asarray(ys, np.int32)
    return (torch.from_numpy(xs), torch.from_numpy(ys), jnp.asarray(xs),
            jnp.asarray(ys))


def _dense(shape, xs, ys, vals):
    d = np.zeros(shape, np.float32)
    np.add.at(d, (ys, xs), vals)
    return d


def test_touch_write_read():
    g, r = _pair((8, 8), block_size=16, capacity=16)
    tx, ty, jx, jy = _xy([0, 17, 100, 127], [0, 33, 50, 127])
    vals = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    g = g.touch_batch(tx, ty).write_batch(tx, ty, vals)
    r = r.touch_batch(jx, jy).write_batch(jx, jy, jnp.asarray(vals))
    _same_grid(g, r, exact=True)
    np.testing.assert_array_equal(g.read_batch(tx, ty).numpy(), [1, 2, 3, 4])
    assert g.shape == r.shape == (128, 128)


def test_untouched_reads_zero():
    g = BlockGrid.create((4, 4), block_size=8, capacity=4, device="cpu")
    assert g.read_batch(np.array([5]), np.array([7])).tolist() == [0.0]


def test_write_accumulates():
    g = BlockGrid.create((2, 2), block_size=8, capacity=4, device="cpu")
    xs, ys = np.array([3, 3, 3]), np.array([4, 4, 4])
    g = g.touch_batch(xs, ys).write_batch(xs, ys, np.array([1.0, 2.0, 3.0]))
    assert float(g.read_batch(np.array([3]), np.array([4]))[0]) == 6.0


def test_touch_idempotent():
    g, r = _pair((4, 4), block_size=8, capacity=8)
    tx, ty, jx, jy = _xy([0, 9, 0, 9], [0, 9, 0, 9])
    g, r = g.touch_batch(tx, ty), r.touch_batch(jx, jy)
    assert int(g.n_allocated()) == 2
    g2 = g.touch_batch(tx, ty)
    _same_grid(g2, r.touch_batch(jx, jy), exact=True)
    assert torch.equal(g.tile_map, g2.tile_map)


@pytest.mark.parametrize("order", ["raster", "morton"])
def test_particle_writes_match_dense(rng, order):
    g, r = _pair((16, 16), block_size=16, capacity=256)
    n = 1 << 12
    xs = rng.integers(0, 256, n).astype(np.int32)
    ys = rng.integers(0, 256, n).astype(np.int32)
    vals = rng.random(n).astype(np.float32)
    tx, ty, jx, jy = _xy(xs, ys)
    g = g.touch_batch(tx, ty, order=order).write_batch(tx, ty, vals)
    r = r.touch_batch(jx, jy, order=order).write_batch(jx, jy,
                                                       jnp.asarray(vals))
    _same_grid(g, r)
    np.testing.assert_allclose(g.todense().numpy(),
                               _dense((256, 256), xs, ys, vals), **TOL)
    np.testing.assert_allclose(g.read_batch(tx, ty).numpy(),
                               np.asarray(r.read_batch(jx, jy)), **TOL)


def test_map_tiles():
    g, r = _pair((2, 2), block_size=8, capacity=4)
    tx, ty, jx, jy = _xy([0], [0])
    g = g.touch_batch(tx, ty).write_batch(tx, ty, torch.tensor([2.0]))
    r = r.touch_batch(jx, jy).write_batch(jx, jy, jnp.asarray([2.0]))
    g = g.map_tiles(lambda t: t * 10.0 + 1.0)
    r = r.map_tiles(lambda t: t * 10.0 + 1.0)
    _same_grid(g, r, exact=True)
    assert float(g.read_batch(tx, ty)[0]) == 21.0


def test_capacity_fail_soft():
    g, r = _pair((4, 4), block_size=8, capacity=2)
    tx, ty, jx, jy = _xy([0, 8, 16, 24], [0, 0, 0, 0])
    g, r = g.touch_batch(tx, ty), r.touch_batch(jx, jy)
    _same_grid(g, r, exact=True)
    assert int(g.n_allocated()) == 2
    assert int((g.tile_map >= 0).sum()) == 2


def test_touch_morton_order(rng):
    """Morton slot assignment: Z-ordered pool layout, as the reference's."""
    g, r = _pair((16, 16), block_size=16, capacity=256)
    xs = rng.integers(0, 256, 500).astype(np.int32)
    ys = rng.integers(0, 256, 500).astype(np.int32)
    tx, ty, jx, jy = _xy(xs, ys)
    g = g.touch_batch(tx, ty, order="morton")
    _same_grid(g, r.touch_batch(jx, jy, order="morton"), exact=True)
    tm = g.tile_map.numpy()
    by, bx = np.nonzero(tm >= 0)
    codes = morton2d_encode(bx, by, device="cpu").numpy().astype(np.int64)
    assert (np.diff(codes[np.argsort(tm[by, bx])]) > 0).all()


def test_write_batch_set_mode():
    """set mode on distinct positions (the value of a position written twice
    is not defined, in the reference as here)."""
    g, r = _pair((4, 4), block_size=8, capacity=8)
    tx, ty, jx, jy = _xy([1, 9, 20, 31], [2, 3, 17, 30])
    vals = np.array([5.0, -1.0, 7.5, 2.0], np.float32)
    g = g.touch_batch(tx[:3], ty[:3]).write_batch(tx, ty, vals)
    g = g.write_batch(tx, ty, vals * 2, mode="set")
    r = r.touch_batch(jx[:3], jy[:3]).write_batch(jx, jy, jnp.asarray(vals))
    r = r.write_batch(jx, jy, jnp.asarray(vals * 2), mode="set")
    _same_grid(g, r, exact=True)
    assert g.read_batch(tx, ty).tolist() == [10.0, -2.0, 15.0, 0.0]
    with pytest.raises(ValueError):
        g.write_batch(tx, ty, vals, mode="max")


def test_write_batch_dense_matches_scatter(rng):
    """Dense-staging write == scatter write == numpy oracle, with duplicate
    destinations and writes to untouched tiles dropped."""
    g0, r0 = _pair((8, 8), block_size=16, capacity=32)
    n = 1 << 11
    xs = rng.integers(0, 128, n).astype(np.int32)
    ys = rng.integers(0, 128, n).astype(np.int32)
    vals = rng.random(n).astype(np.float32)
    touched = xs < 64
    tx, ty, jx, jy = _xy(xs, ys)
    g0 = g0.touch_batch(tx[touched], ty[touched])
    r0 = r0.touch_batch(jx[touched], jy[touched])
    ga = g0.write_batch(tx, ty, vals)
    gb = g0.write_batch_dense(tx, ty, vals)
    _same_grid(gb, r0.write_batch_dense(jx, jy, jnp.asarray(vals)))
    np.testing.assert_allclose(gb.todense().numpy(), ga.todense().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        gb.todense().numpy(),
        _dense((128, 128), xs[touched], ys[touched], vals[touched]), **TOL)


def test_write_batch_dense_morton_and_accumulate(rng):
    g, r = _pair((8, 8), block_size=16, capacity=64)
    n = 1024
    xs = rng.integers(0, 128, n).astype(np.int32)
    ys = rng.integers(0, 128, n).astype(np.int32)
    vals = rng.integers(0, 8, n).astype(np.float32)   # exact sums
    tx, ty, jx, jy = _xy(xs, ys)
    g = g.touch_batch(tx, ty, order="morton")
    r = r.touch_batch(jx, jy, order="morton")
    for _ in range(2):
        g = g.write_batch_dense(tx, ty, vals)
        r = r.write_batch_dense(jx, jy, jnp.asarray(vals))
    _same_grid(g, r, exact=True)
    np.testing.assert_array_equal(g.todense().numpy(),
                                  _dense((128, 128), xs, ys, 2 * vals))


@pytest.mark.parametrize("order", ["raster", "morton"])
def test_carried_state_continues_as_the_reference(rng, order):
    """A grid touched and written by the reference, carried into the port
    (its leaves and static fields), then touched and written again on both
    sides: the two grids stay equal."""
    r = RefGrid.create((16, 16), block_size=8, capacity=96)
    xs = rng.integers(0, 128, 600).astype(np.int32)
    ys = rng.integers(0, 128, 600).astype(np.int32)
    vals = rng.integers(1, 5, 600).astype(np.float32)
    a, b = slice(0, 300), slice(300, 600)
    r = r.touch_batch(jnp.asarray(xs[a]), jnp.asarray(ys[a]), order=order)
    r = r.write_batch(jnp.asarray(xs[a]), jnp.asarray(ys[a]),
                      jnp.asarray(vals[a]))
    g = port_of(r)
    assert_same_container(g, r)
    for fn, args in (("touch_batch", (xs[b], ys[b])),
                     ("write_batch", (xs, ys, vals)),
                     ("write_batch_dense", (xs[b], ys[b], vals[b]))):
        kw = dict(order=order) if fn == "touch_batch" else {}
        g = getattr(g, fn)(*args, **kw)
        r = getattr(r, fn)(*map(jnp.asarray, args), **kw)
    assert_same_container(g, r)
    assert int(g.n_allocated()) == int(r.n_allocated())


# ---- NestedGrid -------------------------------------------------------------


def _npair(grid0, **kw):
    return (NestedGrid.create(grid0, device="cpu", **kw),
            RefNested.create(grid0, **kw))


def test_nested_touch_write_read():
    g, r = _npair((4, 4), mid_grid=(4, 4), block_size=8, cap_mid=16,
                  cap_leaf=64)
    tx, ty, jx, jy = _xy([0, 17, 100, 127], [0, 33, 50, 127])
    vals = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    g = g.touch_batch(tx, ty).write_batch(tx, ty, vals)
    r = r.touch_batch(jx, jy).write_batch(jx, jy, jnp.asarray(vals))
    _same_grid(g, r, exact=True)
    np.testing.assert_array_equal(g.read_batch(tx, ty).numpy(), [1, 2, 3, 4])
    assert g.shape == r.shape == (128, 128)


def test_nested_untouched_reads_zero():
    g = NestedGrid.create((2, 2), mid_grid=(2, 2), block_size=8, cap_mid=4,
                          cap_leaf=8, device="cpu")
    assert g.read_batch(np.array([19]), np.array([21])).tolist() == [0.0]


def test_nested_touch_idempotent():
    g, r = _npair((4, 4), mid_grid=(2, 2), block_size=8, cap_mid=8,
                  cap_leaf=16)
    tx, ty, jx, jy = _xy([0, 40, 0, 40], [0, 40, 0, 40])
    g, r = g.touch_batch(tx, ty), r.touch_batch(jx, jy)
    assert (int(g.n_mid), int(g.n_leaf)) == (2, 2)
    g2 = g.touch_batch(tx, ty)
    _same_grid(g2, r.touch_batch(jx, jy), exact=True)
    assert torch.equal(g.mid_maps, g2.mid_maps)


def test_nested_particle_writes_match_dense(rng):
    g, r = _npair((4, 4), mid_grid=(4, 4), block_size=8, cap_mid=16,
                  cap_leaf=256)
    n = 1 << 12
    xs = rng.integers(0, 128, n).astype(np.int32)
    ys = rng.integers(0, 128, n).astype(np.int32)
    vals = rng.random(n).astype(np.float32)
    tx, ty, jx, jy = _xy(xs, ys)
    g = g.touch_batch(tx, ty).write_batch(tx, ty, vals)
    r = r.touch_batch(jx, jy).write_batch(jx, jy, jnp.asarray(vals))
    _same_grid(g, r)
    np.testing.assert_allclose(g.todense().numpy(),
                               _dense((128, 128), xs, ys, vals), **TOL)


def test_nested_capacity_fail_soft():
    g, r = _npair((2, 2), mid_grid=(4, 4), block_size=8, cap_mid=4,
                  cap_leaf=2)
    tx, ty, jx, jy = _xy([0, 8, 16, 24], [0, 0, 0, 0])
    g, r = g.touch_batch(tx, ty), r.touch_batch(jx, jy)
    _same_grid(g, r, exact=True)
    assert int(g.n_leaf) == 2
    g2, r2 = _npair((4, 4), mid_grid=(2, 2), block_size=8, cap_mid=2,
                    cap_leaf=32)
    tx, _, jx, _ = _xy([0, 16, 32, 48], [0, 0, 0, 0])
    g2, r2 = g2.touch_batch(tx, ty), r2.touch_batch(jx, jy)
    _same_grid(g2, r2, exact=True)
    assert int(g2.n_mid) == 2


def test_nested_map_leaves_and_carried_state():
    g, r = _npair((2, 2), mid_grid=(2, 2), block_size=8, cap_mid=4,
                  cap_leaf=8)
    tx, ty, jx, jy = _xy([3, 20], [5, 2])
    r = r.touch_batch(jx, jy).write_batch(jx, jy, jnp.asarray([2.0, 3.0]))
    g = port_of(r)
    assert_same_container(g, r)
    g = g.map_leaves(lambda t: t * 10.0).write_batch(tx, ty, np.ones(2))
    r = r.map_leaves(lambda t: t * 10.0).write_batch(jx, jy,
                                                     jnp.asarray([1.0, 1.0]))
    assert_same_container(g, r)
    assert g.read_batch(tx, ty).tolist() == [21.0, 31.0]


# ---- Morton codes (tests/test_morton.py against the reference) -------------


def _oracle_encode2d(x, y):
    out = np.zeros_like(x, dtype=np.uint64)
    for b in range(16):
        out |= ((x.astype(np.uint64) >> b) & 1) << (2 * b)
        out |= ((y.astype(np.uint64) >> b) & 1) << (2 * b + 1)
    return out.astype(np.uint32)


def test_encode2d_matches_oracle(rng):
    x = rng.integers(0, 1 << 16, size=1000).astype(np.uint32)
    y = rng.integers(0, 1 << 16, size=1000).astype(np.uint32)
    got = morton2d_encode(x, y, device="cpu")
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), _oracle_encode2d(x, y))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(ref_morton.morton2d_encode(jnp.asarray(x), jnp.asarray(y))))


def test_roundtrip2d(rng):
    x = rng.integers(0, 1 << 16, size=1000).astype(np.uint32)
    y = rng.integers(0, 1 << 16, size=1000).astype(np.uint32)
    code = morton2d_encode(torch.from_numpy(x.astype(np.int64)),
                           torch.from_numpy(y.astype(np.int64)))
    dx, dy = morton2d_decode(code)
    np.testing.assert_array_equal(dx.numpy(), x)
    np.testing.assert_array_equal(dy.numpy(), y)


@pytest.mark.parametrize("v", [0, 1, 2, 255, 256, 65535])
def test_edge_values(v):
    c = morton2d_encode(v, 0, device="cpu")
    dx, dy = morton2d_decode(c)
    assert int(dx) == v and int(dy) == 0
    want = ref_morton.morton2d_encode(jnp.uint32(v), jnp.uint32(v))
    got = morton2d_encode(np.uint32(v), np.uint32(v), device="cpu")
    assert int(got.view(torch.int32)) & 0xFFFFFFFF == int(want)
    dx, dy = morton2d_decode(got)   # 65535: the code is 0xFFFFFFFF
    assert (int(dx), int(dy)) == (v, v)


def test_roundtrip3d(rng):
    x = rng.integers(0, 1 << 10, size=500).astype(np.uint32)
    y = rng.integers(0, 1 << 10, size=500).astype(np.uint32)
    z = rng.integers(0, 1 << 10, size=500).astype(np.uint32)
    x[:3], y[:3], z[:3] = [0, 0x3FF, 0x3FF], [0, 0x3FF, 0], [0, 0x3FF, 0x3FF]
    code = morton3d_encode(x, y, z, device="cpu")
    np.testing.assert_array_equal(
        code.numpy(),
        np.asarray(ref_morton.morton3d_encode(jnp.asarray(x), jnp.asarray(y),
                                              jnp.asarray(z))))
    assert int(code[1]) == (1 << 30) - 1
    for got, want in zip(morton3d_decode(code), (x, y, z)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_locality():
    codes = [int(morton2d_encode(x, y, device="cpu"))
             for x, y in ((0, 0), (1, 0), (0, 1), (1, 1))]
    assert codes == [0, 1, 2, 3]


# ---- tiles past the map: the reference's scatters drop them ----------------


@pytest.mark.parametrize("shape,bs,cap,xs,ys,order", [
    ((2, 2), 16, 8, [5, 5], [3, 40], "raster"),   # a tile row past the map
    ((2, 2), 16, 8, [5, 5], [3, 40], "morton"),
    ((2, 2), 16, 8, [5, 40], [3, 3], "morton"),   # a tile column past it
    ((2, 2), 4, 8, [0, 5, 9], [0, 0, 7], "raster"),
])
def test_touch_past_the_map_matches_the_reference(shape, bs, cap, xs, ys,
                                                   order):
    """A touched tile outside tile_map takes a pool slot (n_active counts
    it, tile_pos records its raster id) but no map entry points to it; no
    other tile is allocated in its place."""
    g, r = _pair(shape, block_size=bs, capacity=cap)
    tx, ty, jx, jy = _xy(xs, ys)
    g = g.touch_batch(tx, ty, order=order)
    r = r.touch_batch(jx, jy, order=order)
    _same_grid(g, r, exact=True)
    assert int(g.n_active) == int(r.n_active)


def test_nested_touch_past_the_map_matches_the_reference():
    g, r = _npair((2, 2), mid_grid=(2, 2), block_size=4, cap_mid=8,
                  cap_leaf=16)
    tx, ty, jx, jy = _xy([1, 1], [1, 20])
    g, r = g.touch_batch(tx, ty), r.touch_batch(jx, jy)
    _same_grid(g, r, exact=True)
    assert g.map0.tolist() == [[0, -1], [-1, -1]]
    assert (int(g.n_mid), int(g.n_leaf)) == (2, 1)
