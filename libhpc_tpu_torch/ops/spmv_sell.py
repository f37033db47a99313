"""SELL — striped scalar-ELL SpMV for banded and structured matrices.

Port of ``libhpc_tpu/ops/ell_pallas.py`` (``SELL``, ``SELLSplit``,
``sell_from_ell``, ``sell_from_scipy``, ``sell_spmv``):

  ``sell_out_panes`` wraps the hand-written CUDA kernel ``csrc/sell.cu``
    (K6, the port of ``ell_pallas.py:_kernel``); ``sell_out_panes_torch`` is
    its plain PyTorch version (a gather plus ``index_add_`` over ``sid``).

Layout (the reference's): stripes of 1024 rows arranged as (8, 128) slots,
row r = 1024 s + 8 l + j at sublane j, lane l — the pane convention of x.
One tile is ELL slice k of stripe s: an (8, 128) value plane and an (8, 128)
plane of absolute columns. Every (stripe, slice) must fit a W-pane window;
the builder raises ``ValueError`` otherwise (``sparse/auto.py`` routes on
it). The TPU kernel needs the window because it gathers x by W*8 sublane
rotations; the Hopper kernel loads x3[c >> 10, c & 7, (c >> 3) & 127]
directly, but the container, and so the window rule, stays the reference's.

The reference refuses operands whose x panes and output exceed its VMEM
budget (``VMEM_CAP``); the Hopper kernel reads x from global memory, so the
port has no such guard. The tile order the kernel walks (``tile_order``,
``tile_ptr``) is derived on the host from ``sid``. The wrapper runs the
plain version for CPU tensors only; for CUDA tensors it launches the kernel
or raises. ``SELL_LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.ops._cuda_utils import (check_launch, check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)
from libhpc_tpu_torch.sparse._leaves import TensorLeaves, tensor_to_numpy

B = 8
LANE = 128
PANE = B * LANE          # 1024 rows/cols per stripe/pane
TPB = 16                 # tile-stream padding multiple
W_DEFAULT = 3            # x panes a slice's columns may span

SELL_LAUNCHES = 0


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def stripe_walk(sid: np.ndarray, n_stripes: int):
    """(tile_order, tile_ptr): the tiles stably sorted by stripe, and the
    CSR-style offsets of each stripe's run in that order. A kernel block
    walks tile_order[tile_ptr[s]:tile_ptr[s+1]] for stripe s, which adds a
    stripe's tiles in the order of the tile stream, as the reference's
    sequential grid does (padding tiles, sid 0, last in stripe 0)."""
    sid = sid.astype(np.int64)
    order = np.argsort(sid, kind="stable")
    ptr = np.searchsorted(sid[order], np.arange(n_stripes + 1), side="left")
    return order.astype(np.int32), ptr.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SELL(TensorLeaves):
    """Striped scalar-ELL (see module docstring)."""

    vflat: torch.Tensor   # (n_tiles*B, LANE) f32 value planes
    cflat: torch.Tensor   # (n_tiles*B, LANE) i32 absolute columns
    pane: torch.Tensor    # (n_tiles,) i32 x-pane window base per tile
    sid: torch.Tensor     # (n_tiles,) i32 stripe id per tile
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_stripes: int = dataclasses.field(metadata=dict(static=True))
    n_panes: int = dataclasses.field(metadata=dict(static=True))
    W: int = dataclasses.field(metadata=dict(static=True))
    # derived, not in the reference: the kernel's walk (stripe_walk)
    tile_order: torch.Tensor | None = dataclasses.field(
        default=None, metadata=dict(derived=True))
    tile_ptr: torch.Tensor | None = dataclasses.field(
        default=None, metadata=dict(derived=True))

    def __post_init__(self):
        if self.tile_ptr is None:
            order, ptr = stripe_walk(self.sid.cpu().numpy(), self.n_stripes)
            object.__setattr__(self, "tile_order",
                               _t(order).to(self.sid.device))
            object.__setattr__(self, "tile_ptr", _t(ptr).to(self.sid.device))

    @property
    def n_tiles(self) -> int:
        return self.vflat.shape[0] // B

    @property
    def hbm_bytes(self) -> int:
        """Streamed per SpMV: value+column planes + x + y."""
        return (self.vflat.numel() * 4 + self.cflat.numel() * 4
                + self.n_panes * PANE * 4 + self.n_stripes * PANE * 4)


@dataclasses.dataclass(frozen=True)
class SELLSplit(TensorLeaves):
    """Span-split SELL: single-pane tiles (near, W=1) + multi-pane tiles
    (wide, W=max span). Two kernel calls on one shared x; outputs add in
    the stripe layout."""

    near: SELL
    wide: SELL
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def n_stripes(self) -> int:
        return self.near.n_stripes

    @property
    def n_panes(self) -> int:
        return self.near.n_panes

    @property
    def W(self) -> int:
        return self.wide.W

    @property
    def n_tiles(self) -> int:
        return self.near.n_tiles + self.wide.n_tiles

    @property
    def hbm_bytes(self) -> int:
        """Streamed per SpMV: both tile streams + x + y once."""
        return (self.near.vflat.numel() * 8 + self.wide.vflat.numel() * 8
                + self.n_panes * PANE * 4 + self.n_stripes * PANE * 4)


def sell_from_ell(ell, W: int = W_DEFAULT, device="cuda"):
    """Host-side SELL build from an ELL container (sparse/ell.py), on any
    device; the leaves move to ``device`` once at the end.

    Zero-valued slots are treated as padding (their column is rewritten
    to the window base — the product is zero either way). All-zero
    slices are dropped, so ELL's k-rounding padding costs nothing."""
    vals = tensor_to_numpy(ell.vals).astype(np.float32)
    cols = tensor_to_numpy(ell.cols).astype(np.int64)
    m, n = ell.shape
    K = vals.shape[1]
    n_stripes = -(-m // PANE)
    n_panes = -(-n // PANE)
    mp = n_stripes * PANE
    if mp != m:
        vals = np.pad(vals, ((0, mp - m), (0, 0)))
        cols = np.pad(cols, ((0, mp - m), (0, 0)))

    groups = {}        # span -> (tiles_v, tiles_c, pane, sid, [max span])
    for s in range(n_stripes):
        for k in range(K):
            v = vals[s * PANE:(s + 1) * PANE, k]
            c = cols[s * PANE:(s + 1) * PANE, k]
            nz = v != 0.0
            if not nz.any():
                continue
            lo = int(c[nz].min()) >> 10
            hi = int(c[nz].max()) >> 10
            if hi - lo >= W:
                raise ValueError(
                    f"sell_from_ell: stripe {s} slice {k} spans panes "
                    f"{lo}..{hi} (> W={W}); this matrix is too "
                    "wide-scattered for the SELL window kernel — use the "
                    "SBELL path (ops/spmv_sbell.py) instead")
            c = np.where(nz, c, lo << 10)
            # span bucket: single-pane tiles (1) vs the rest
            key = 1 if hi == lo else 2
            g = groups.setdefault(key, ([], [], [], [], [1]))
            g[0].append(v.reshape(LANE, B).T)
            g[1].append(c.reshape(LANE, B).T.astype(np.int32))
            g[2].append(lo)
            g[3].append(s)
            g[4][0] = max(g[4][0], hi - lo + 1)

    def _pack(g, w):
        tiles_v, tiles_c, pane, sid = g
        n_tiles = max(len(tiles_v), 1)
        n_pad = -(-n_tiles // TPB) * TPB
        vflat = np.zeros((n_pad, B, LANE), np.float32)
        cflat = np.zeros((n_pad, B, LANE), np.int32)
        pane_a = np.zeros(n_pad, np.int32)
        sid_a = np.zeros(n_pad, np.int32)
        for t in range(len(tiles_v)):
            vflat[t] = tiles_v[t]
            cflat[t] = tiles_c[t]
            pane_a[t] = pane[t]
            sid_a[t] = sid[t]
        return SELL(vflat=_t(vflat.reshape(n_pad * B, LANE)),
                    cflat=_t(cflat.reshape(n_pad * B, LANE)),
                    pane=_t(pane_a), sid=_t(sid_a),
                    shape=(m, n), n_stripes=n_stripes, n_panes=n_panes,
                    W=w)

    near = groups.get(1)
    wide = groups.get(2)
    if near and wide and len(near[0]) >= TPB:
        # span split: single-pane tiles run a W=1 call of their own
        built = SELLSplit(near=_pack(near[:4], 1),
                          wide=_pack(wide[:4], wide[4][0]), shape=(m, n))
    elif near and wide:        # too few near tiles to pay a second call
        merged = tuple(a + b for a, b in zip(near[:4], wide[:4]))
        built = _pack(merged, wide[4][0])
    else:
        g = near or wide or ([], [], [], [], [1])
        built = _pack(g[:4], g[4][0])
    return built.to(device)


def sell_from_scipy(A, W: int = W_DEFAULT, device="cuda"):
    from libhpc_tpu_torch.sparse.ell import ELL

    return sell_from_ell(ELL.from_scipy(A, device="cpu"), W=W, device=device)


def sell_out_panes_torch(sp: SELL, x3: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: ((n_stripes + W - 1) * B, LANE) f32 with
    out[8 sid + j, l] += V[j, l] * x3[c >> 10, c & 7, (c >> 3) & 127] for
    c = C[j, l], tile by tile; the guard stripes stay zero."""
    T = sp.n_tiles
    c = sp.cflat.reshape(T, B, LANE).long()
    gx = x3[c >> 10, c & (B - 1), (c >> 3) & (LANE - 1)]
    prod = sp.vflat.reshape(T, B, LANE) * gx
    out = torch.zeros((sp.n_stripes + sp.W - 1, B, LANE),
                      dtype=torch.float32, device=x3.device)
    out.index_add_(0, sp.sid.long(), prod)
    return out.reshape(-1, LANE)


def sell_out_panes(sp: SELL, x3: torch.Tensor) -> torch.Tensor:
    """K6: the SELL product in the guarded output layout ((n_stripes + W -
    1) * B, LANE) f32. x3 is the x pane array (p, B, LANE) with at least
    n_panes + W - 1 panes, the trailing ones zero."""
    global SELL_LAUNCHES
    dev = kernel_device(sp.vflat, sp.cflat, sp.tile_order, sp.tile_ptr, x3)
    if dev.type == "cpu":
        return sell_out_panes_torch(sp, x3)
    T, S = sp.n_tiles, sp.n_stripes
    check_tensor(sp.vflat, "vflat", dev, (torch.float32,), (T * B, LANE))
    check_tensor(sp.cflat, "cflat", dev, (torch.int32,), (T * B, LANE))
    check_tensor(sp.tile_order, "tile_order", dev, (torch.int32,), (T,))
    check_tensor(sp.tile_ptr, "tile_ptr", dev, (torch.int32,), (S + 1,))
    if x3.ndim != 3 or x3.shape[0] < sp.n_panes + sp.W - 1:
        raise ValueError(f"x3: shape {tuple(x3.shape)}, expected at least "
                         f"{sp.n_panes + sp.W - 1} panes")
    check_tensor(x3, "x3", dev, (torch.float32,), (x3.shape[0], B, LANE))
    out = torch.zeros(((S + sp.W - 1) * B, LANE), dtype=torch.float32,
                      device=dev)
    fn = kernel_fn("sell_spmv_f32", 6, 1)
    with torch.cuda.device(dev):
        rc = fn(sp.vflat.data_ptr(), sp.cflat.data_ptr(),
                sp.tile_order.data_ptr(), sp.tile_ptr.data_ptr(),
                x3.data_ptr(), out.data_ptr(), S, current_stream_ptr())
    check_launch(rc, "sell_spmv_f32")
    SELL_LAUNCHES += 1
    return out


def x_panes(x: torch.Tensor, n_panes: int, n_guard: int = 0
            ) -> torch.Tensor:
    """x (ncols,) -> contiguous pane array (n_panes + n_guard, B, LANE):
    x3[p, j, l] = x[1024 p + 8 l + j], zero past ncols and in the n_guard
    trailing panes."""
    xpad = torch.nn.functional.pad(x, (0, n_panes * PANE - x.shape[0]))
    x3 = xpad.reshape(n_panes, LANE, B).transpose(1, 2)
    return torch.cat([x3, x3.new_zeros((n_guard, B, LANE))])


def _depane(out: torch.Tensor, n_stripes: int, m: int) -> torch.Tensor:
    y = out[:n_stripes * B].reshape(n_stripes, B, LANE) \
        .transpose(1, 2).reshape(-1)
    return y[:m]


def sell_spmv(sp, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for SELL / SELLSplit A; x f32 (ncols,) -> f32 (nrows,)."""
    x3 = x_panes(x, sp.n_panes, sp.W - 1)
    if isinstance(sp, SELLSplit):
        ns = sp.n_stripes * B
        out = (sell_out_panes(sp.near, x3)[:ns]
               + sell_out_panes(sp.wide, x3)[:ns])
    else:
        out = sell_out_panes(sp, x3)
    return _depane(out, sp.n_stripes, sp.shape[0])
