"""Hierarchical sparse block grid.

Port of ``libhpc_tpu/sparse/grid.py``, the re-expression of libHPC's
lib/sparse stack (RootGrid / PointerBlock / HashBlock / DenseBlock,
lib/sparse/include/RootGrid.hpp:12, SparseDS.hpp:4-7) without atomics or
pointers:

  tile_map (Gy, Gx) int32   the 'pointer block': slot id or -1 (= null)
  tile_pos (capacity,) int32  slot -> tile raster id, or -1
  tiles (capacity, B, B)    the pool of dense leaf blocks
  n_active () int32         bump 'allocator' cursor

and the mutation API is batched: ``touch_batch`` replaces insert-on-touch
with sort-dedupe-allocate, ``write_batch`` replaces CAS scatter with one
scatter-add. Every method returns a new grid (the reference's arrays are
immutable): the port copies what a method changes and leaves its input
as it was. ``NestedGrid`` is the three-level form (pointer -> mid ->
dense leaf). Plain torch throughout; the reference has no Pallas kernel
here.

Translations: ``.at[].max`` is ``scatter_reduce_(..., "amax")``;
``.at[...].add/set(..., mode="drop")`` is ``index_add_`` / ``index_put_``
into a buffer with one spare element that takes the dropped writes;
``lax.sort`` and ``argsort(stable=True)`` are ``torch.sort(stable=True)``.
Tile ids are sorted as int64 values of their u32 codes. Coordinates index
the grid as in the reference, where a gather clamps indices past the last
row or column and a scatter drops them (a tile past the map takes a pool
slot that no map entry points to); negative coordinates are outside both
APIs.

Under ``write_batch(mode="set")`` the value that lands in a position
written twice is not defined, in the reference as here. ``create`` takes a
torch dtype and builds on ``device`` (default ``"cuda"``); numpy
coordinates and values go to the grid's device.
"""

from __future__ import annotations

import dataclasses

import torch

from libhpc_tpu_torch.ops._cuda_utils import as_tensor
from libhpc_tpu_torch.sparse._leaves import TensorLeaves
from libhpc_tpu_torch.utils.morton import morton2d_decode, morton2d_encode

_SENTINEL = 0xFFFFFFFF   # the u32 'invalid key' of _alloc_slots


def _coords(xs, ys, device):
    """Coordinates as int32 tensors; numpy input goes to the grid's device."""
    return (as_tensor(xs, device).to(torch.int32),
            as_tensor(ys, device).to(torch.int32))


def _gather2(m: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    """m[iy, ix] with indices clamped into m (a jnp gather's behaviour)."""
    gy, gx = m.shape
    return m[iy.clamp(0, gy - 1), ix.clamp(0, gx - 1)]


def _gather1(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return v[i.clamp(0, v.shape[0] - 1)]


def _u32_i64(code: torch.Tensor) -> torch.Tensor:
    """A torch.uint32 tensor as int64 values in [0, 2^32)."""
    return code.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _unique_first(keys: torch.Tensor):
    """Sorted keys with the unique ones packed first (ascending), the rest
    of the tail duplicates, and the number of unique keys (a 0-d tensor):
    sort + head flags + stable argsort of the flags."""
    ks = torch.sort(keys).values
    is_head = torch.ones_like(ks, dtype=torch.bool)
    is_head[1:] = ks[1:] != ks[:-1]
    head_order = torch.sort((~is_head).to(torch.int8), stable=True).indices
    return ks[head_order], is_head.sum(dtype=torch.int32)


def _scatter_drop(flat: torch.Tensor, idx: torch.Tensor, vals, mode: str):
    """A copy of flat with vals added ('add') or stored ('set') at idx,
    where idx == flat.numel() marks a dropped write."""
    n = flat.numel()
    buf = torch.empty(n + 1, dtype=flat.dtype, device=flat.device)
    buf[:n] = flat
    vals = as_tensor(vals, flat.device).to(flat.dtype).reshape(-1)
    if mode == "add":
        buf.index_add_(0, idx, vals)
    elif mode == "set":
        buf.index_put_((idx,), vals)
    else:
        raise ValueError(mode)
    return buf[:n]


@dataclasses.dataclass(frozen=True)
class BlockGrid(TensorLeaves):
    tile_map: torch.Tensor   # (Gy, Gx) int32, -1 = unallocated
    tile_pos: torch.Tensor   # (capacity,) int32: slot -> tile raster id (-1)
    tiles: torch.Tensor      # (capacity, B, B)
    n_active: torch.Tensor   # () int32
    block_size: int = dataclasses.field(metadata=dict(static=True))
    capacity: int = dataclasses.field(metadata=dict(static=True))

    # -- construction ------------------------------------------------------

    @staticmethod
    def create(grid_blocks: tuple, block_size: int = 16,
               capacity: int = 1024, dtype=torch.float32, *,
               device="cuda") -> "BlockGrid":
        gy, gx = grid_blocks
        return BlockGrid(
            tile_map=torch.full((gy, gx), -1, dtype=torch.int32,
                                device=device),
            tile_pos=torch.full((capacity,), -1, dtype=torch.int32,
                                device=device),
            tiles=torch.zeros((capacity, block_size, block_size),
                              dtype=dtype, device=device),
            n_active=torch.zeros((), dtype=torch.int32, device=device),
            block_size=block_size,
            capacity=capacity,
        )

    @property
    def shape(self) -> tuple:
        """Element-level extent (y, x)."""
        gy, gx = self.tile_map.shape
        return (gy * self.block_size, gx * self.block_size)

    def _split(self, xs, ys):
        b = self.block_size
        return xs // b, ys // b, xs % b, ys % b

    # -- touch (allocation) ------------------------------------------------

    def touch_batch(self, xs, ys, order: str = "raster") -> "BlockGrid":
        """Allocate leaf tiles for every (x, y) — batched insert-on-touch:
        dedupe by sort + head flags, then assign pool slots in order.
        Already-allocated tiles keep their slot; tiles past capacity stay
        unallocated (fail-soft)."""
        xs, ys = _coords(xs, ys, self.device)
        bx, by, _, _ = self._split(xs, ys)
        gy, gx = self.tile_map.shape
        if order == "morton":
            # the Morton code is a bijection of (bx, by): the tile id
            tid = _u32_i64(morton2d_encode(bx, by))
        else:
            tid = (by * gx + bx).to(torch.int64) & 0xFFFFFFFF
        uniq, n_uniq = _unique_first(tid)
        k = torch.arange(tid.shape[0], device=tid.device)
        if order == "morton":
            ux32, uy32 = morton2d_decode(uniq)
            ux, uy = ux32.view(torch.int32), uy32.view(torch.int32)
        else:
            uniq_i = uniq.to(torch.int32)
            uy, ux = uniq_i // gx, uniq_i % gx
        existing = _gather2(self.tile_map, uy, ux)
        is_new = (existing < 0) & (k < n_uniq)
        new_i = is_new.to(torch.int32)
        new_rank = torch.cumsum(new_i, 0, dtype=torch.int32) - new_i
        slot = torch.where(is_new, self.n_active + new_rank, existing)
        slot = torch.where(slot < self.capacity, slot, existing)
        do_write = is_new & (slot >= 0)
        # the reference's 2-D scatter drops a tile outside the map; the
        # tile still takes its slot, and tile_pos records its raster id
        in_map = do_write & (uy < gy) & (ux < gx)
        flat_t = torch.where(in_map, uy * gx + ux, 0).to(torch.int64)
        tm = self.tile_map.reshape(-1).scatter_reduce(
            0, flat_t, torch.where(in_map, slot, -1), "amax")
        # inverse map slot -> tile raster id; writes for non-allocations drop
        pos = torch.where(do_write, slot, self.capacity).to(torch.int64)
        tp = _scatter_drop(self.tile_pos, pos, uy * gx + ux, "set")
        n_new = torch.clamp(self.n_active + new_i.sum(dtype=torch.int32),
                            max=self.capacity)
        return dataclasses.replace(self, tile_map=tm.view(gy, gx),
                                   tile_pos=tp, n_active=n_new)

    # -- read / write ------------------------------------------------------

    def _lin(self, xs, ys):
        """Flat pool index of each element and its tile's slot."""
        bx, by, ox, oy = self._split(xs, ys)
        slot = _gather2(self.tile_map, by, bx)
        b = self.block_size
        return slot.to(torch.int64) * (b * b) + oy * b + ox, slot

    def write_batch(self, xs, ys, vals, mode: str = "add") -> "BlockGrid":
        """Batched write into touched tiles — the particle-write workload
        (test_hpc_benchmark.cpp:866-870: 2^20 writes per iteration).
        Writes to untouched tiles are dropped."""
        if mode not in ("add", "set"):
            raise ValueError(mode)
        xs, ys = _coords(xs, ys, self.device)
        lin, slot = self._lin(xs, ys)
        n_lin = self.tiles.numel()
        lin_safe = torch.where(slot >= 0, lin, n_lin)
        flat = _scatter_drop(self.tiles.reshape(-1), lin_safe, vals, mode)
        return dataclasses.replace(self, tiles=flat.view(self.tiles.shape))

    def write_batch_dense(self, xs, ys, vals) -> "BlockGrid":
        """Accumulating batched write through a dense staging image: writes
        scatter into a dense (Gy·B, Gx·B) zero image by raster coordinate,
        and each active slot pulls its tile from the image through the
        slot -> tile inverse map. Writes to untouched tiles are dropped, as
        in ``write_batch``. Add mode only."""
        xs, ys = _coords(xs, ys, self.device)
        gy, gx = self.tile_map.shape
        b = self.block_size
        w = gx * b
        n_img = gy * b * w
        lin = ys.to(torch.int64) * w + xs
        lin = torch.where((lin >= 0) & (lin < n_img), lin, n_img)
        zeros = torch.zeros(n_img, dtype=self.tiles.dtype,
                            device=self.tiles.device)
        dense = _scatter_drop(zeros, lin, vals, "add")
        dense4 = dense.view(gy, b, gx, b).transpose(1, 2).reshape(gy * gx,
                                                                  b, b)
        delta = dense4[self.tile_pos.clamp(min=0)]
        active = (torch.arange(self.capacity, device=self.tiles.device)
                  < self.n_active)[:, None, None]
        return dataclasses.replace(
            self, tiles=torch.where(active, self.tiles + delta, self.tiles))

    def read_batch(self, xs, ys) -> torch.Tensor:
        """Batched read; unallocated tiles read as 0 (the reference returns
        T{} for null blocks, RootGrid.hpp:25-45)."""
        xs, ys = _coords(xs, ys, self.device)
        bx, by, ox, oy = self._split(xs, ys)
        slot = _gather2(self.tile_map, by, bx)
        b = self.block_size
        lin = (slot.clamp(0, self.capacity - 1).to(torch.int64) * (b * b)
               + oy * b + ox)
        vals = _gather1(self.tiles.reshape(-1), lin)
        return torch.where(slot >= 0, vals, torch.zeros_like(vals))

    # -- foreach / todense -------------------------------------------------

    def map_tiles(self, fn) -> "BlockGrid":
        """Apply fn: (B, B) -> (B, B) over all *active* tiles (the
        reference's foreach, DenseBlock.hpp:63-70); inactive pool slots are
        left as they are."""
        active = torch.arange(self.capacity, device=self.tiles.device) \
            < self.n_active
        new_tiles = torch.vmap(fn)(self.tiles)
        tiles = torch.where(active[:, None, None], new_tiles, self.tiles)
        return dataclasses.replace(self, tiles=tiles)

    def todense(self) -> torch.Tensor:
        gy, gx = self.tile_map.shape
        b = self.block_size
        slot = self.tile_map
        vals = self.tiles[slot.clamp(0, self.capacity - 1)]  # (gy,gx,b,b)
        vals = torch.where((slot >= 0)[:, :, None, None], vals,
                           torch.zeros_like(vals))
        return vals.transpose(1, 2).reshape(gy * b, gx * b)

    def n_allocated(self) -> torch.Tensor:
        return self.n_active


# ---------------------------------------------------------------------------
# generic batched slot allocator (shared by nested grids)
# ---------------------------------------------------------------------------


def _alloc_slots(flat_map, keys, n_active, capacity: int):
    """Batched dedupe-allocate over a flat int32 slot map (-1 = empty).

    keys: u32 values as int64 (or a torch.uint32 tensor); 0xFFFFFFFF is
    the 'invalid' sentinel (dropped). For each unique valid key, keep the
    existing slot or assign the next pool slot; fail-soft past capacity.
    Returns (new flat map, new n_active)."""
    if keys.dtype == torch.uint32:
        keys = _u32_i64(keys)
    uniq, n_uniq = _unique_first(keys)
    k = torch.arange(keys.shape[0], device=keys.device)
    valid = uniq != _SENTINEL
    uniq_i = torch.where(valid, uniq, 0).to(torch.int32)
    existing = _gather1(flat_map, uniq_i)
    is_new = valid & (existing < 0) & (k < n_uniq)
    new_i = is_new.to(torch.int32)
    new_rank = torch.cumsum(new_i, 0, dtype=torch.int32) - new_i
    slot = torch.where(is_new, n_active + new_rank, existing)
    slot = torch.where(slot < capacity, slot, existing)  # fail-soft
    do_write = is_new & (slot >= 0)
    # a key past the map is dropped by the reference's scatter (it still
    # takes its slot)
    in_map = do_write & (uniq_i >= 0) & (uniq_i < flat_map.shape[0])
    fm = flat_map.scatter_reduce(
        0, torch.where(in_map, uniq_i, 0).to(torch.int64),
        torch.where(in_map, slot, -1), "amax")
    n_new = torch.clamp(n_active + new_i.sum(dtype=torch.int32),
                        max=capacity)
    return fm, n_new


# ---------------------------------------------------------------------------
# 3-level nested grid (pointer -> mid -> dense leaf parity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NestedGrid(TensorLeaves):
    """Three-level sparse grid, the composed layout stacks of the reference
    (e.g. PointerBlock<N, HashBlock<DenseBlock<B>>>):

      map0 (G0y, G0x) int32        top pointer grid: mid slot or -1
      mid_maps (cap_mid, G1y, G1x) per-mid pointer grids: leaf slot or -1
      leaves (cap_leaf, B, B)      dense leaf pool

    Element (x, y) resolves through two indirections; all mutation is
    batched sort-dedupe-allocate."""

    map0: torch.Tensor
    mid_maps: torch.Tensor
    leaves: torch.Tensor
    n_mid: torch.Tensor
    n_leaf: torch.Tensor
    block_size: int = dataclasses.field(metadata=dict(static=True))
    mid_grid: tuple = dataclasses.field(metadata=dict(static=True))
    cap_mid: int = dataclasses.field(metadata=dict(static=True))
    cap_leaf: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def create(grid0: tuple, mid_grid: tuple = (8, 8), block_size: int = 16,
               cap_mid: int = 64, cap_leaf: int = 1024,
               dtype=torch.float32, *, device="cuda") -> "NestedGrid":
        g0y, g0x = grid0
        g1y, g1x = mid_grid
        return NestedGrid(
            map0=torch.full((g0y, g0x), -1, dtype=torch.int32,
                            device=device),
            mid_maps=torch.full((cap_mid, g1y, g1x), -1, dtype=torch.int32,
                                device=device),
            leaves=torch.zeros((cap_leaf, block_size, block_size),
                               dtype=dtype, device=device),
            n_mid=torch.zeros((), dtype=torch.int32, device=device),
            n_leaf=torch.zeros((), dtype=torch.int32, device=device),
            block_size=block_size,
            mid_grid=(g1y, g1x),
            cap_mid=cap_mid,
            cap_leaf=cap_leaf,
        )

    @property
    def shape(self) -> tuple:
        g0y, g0x = self.map0.shape
        g1y, g1x = self.mid_grid
        b = self.block_size
        return (g0y * g1y * b, g0x * g1x * b)

    def _split(self, xs, ys):
        b = self.block_size
        g1y, g1x = self.mid_grid
        ox, oy = xs % b, ys % b
        tx, ty = xs // b, ys // b
        bx1, by1 = tx % g1x, ty % g1y
        bx0, by0 = tx // g1x, ty // g1y
        return bx0, by0, bx1, by1, ox, oy

    def touch_batch(self, xs, ys) -> "NestedGrid":
        xs, ys = _coords(xs, ys, self.device)
        bx0, by0, bx1, by1, _, _ = self._split(xs, ys)
        g0y, g0x = self.map0.shape
        g1y, g1x = self.mid_grid
        # level 0: allocate mid blocks
        key0 = (by0 * g0x + bx0).to(torch.int64) & 0xFFFFFFFF
        m0, n_mid = _alloc_slots(self.map0.reshape(-1), key0, self.n_mid,
                                 self.cap_mid)
        slot0 = _gather1(m0, by0 * g0x + bx0)
        # level 1: allocate leaves within each allocated mid block
        key1 = (slot0 * (g1y * g1x) + by1 * g1x + bx1).to(torch.int64)
        key1 = torch.where(slot0 >= 0, key1 & 0xFFFFFFFF, _SENTINEL)
        m1, n_leaf = _alloc_slots(self.mid_maps.reshape(-1), key1,
                                  self.n_leaf, self.cap_leaf)
        return dataclasses.replace(
            self, map0=m0.view(g0y, g0x),
            mid_maps=m1.view(self.mid_maps.shape),
            n_mid=n_mid, n_leaf=n_leaf)

    def _leaf_lin(self, xs, ys):
        """Linear leaf-pool index per element; -1 where unallocated."""
        bx0, by0, bx1, by1, ox, oy = self._split(xs, ys)
        g1y, g1x = self.mid_grid
        b = self.block_size
        slot0 = _gather2(self.map0, by0, bx0)
        mid_idx = (slot0.clamp(0, self.cap_mid - 1) * (g1y * g1x)
                   + by1 * g1x + bx1)
        slot1 = _gather1(self.mid_maps.reshape(-1), mid_idx)
        slot1 = torch.where(slot0 >= 0, slot1, -1)
        lin = slot1.to(torch.int64) * (b * b) + oy * b + ox
        return torch.where(slot1 >= 0, lin, -1)

    def write_batch(self, xs, ys, vals, mode: str = "add") -> "NestedGrid":
        if mode not in ("add", "set"):
            raise ValueError(mode)
        xs, ys = _coords(xs, ys, self.device)
        lin = self._leaf_lin(xs, ys)
        n_lin = self.leaves.numel()
        lin_safe = torch.where(lin >= 0, lin, n_lin)
        flat = _scatter_drop(self.leaves.reshape(-1), lin_safe, vals, mode)
        return dataclasses.replace(self,
                                   leaves=flat.view(self.leaves.shape))

    def read_batch(self, xs, ys) -> torch.Tensor:
        xs, ys = _coords(xs, ys, self.device)
        lin = self._leaf_lin(xs, ys)
        vals = _gather1(self.leaves.reshape(-1), lin.clamp(min=0))
        return torch.where(lin >= 0, vals, torch.zeros_like(vals))

    def map_leaves(self, fn) -> "NestedGrid":
        """fn: (B, B) -> (B, B) over active leaves (the reference's foreach
        recursion, RootGrid.hpp:62-75)."""
        active = torch.arange(self.cap_leaf, device=self.leaves.device) \
            < self.n_leaf
        new = torch.vmap(fn)(self.leaves)
        leaves = torch.where(active[:, None, None], new, self.leaves)
        return dataclasses.replace(self, leaves=leaves)

    def todense(self) -> torch.Tensor:
        h, w = self.shape
        dev = self.map0.device
        yy = torch.arange(h, dtype=torch.int32, device=dev)
        xx = torch.arange(w, dtype=torch.int32, device=dev)
        return self.read_batch(xx.repeat(h),
                               yy.repeat_interleave(w)).view(h, w)
