"""SELL-P — per-row-sourced plane ELL.

Port of ``libhpc_tpu/ops/sellp.py`` (``SELLP``, ``sellp_from_scipy``,
``sellp_spmv``):

  ``sellp_out_panes`` wraps the hand-written CUDA kernel ``csrc/sellp.cu``
    (K7, the port of ``sellp.py:_kernel``); ``sellp_out_panes_torch`` is its
    plain PyTorch version (a gather plus ``index_add_`` over ``sid``).

Layout (the reference's): each entry is keyed by its x target's (pane,
sublane jp); entries sharing a key and an output sublane j form a row unit,
128 lanes whose x reads all come from the single x row x3[pane, jp, :].
A tile packs up to 8 units of one pane, one per output sublane, so slot
(j, l) is output row 1024 sid + 8 l + j. ``lidx`` holds the lane in bits
0-6 and the unit's jp in bits 7-9. No pane window applies.

The reference interleaves tiles round-robin across stripes (a TPU
read-modify-write trick). The kernel walks each stripe's tiles in that
order through ``tile_order`` / ``tile_ptr``, derived on the host by a stable
sort on ``sid`` (``ops/spmv_sell.py:stripe_walk``), so its sums match the
reference's. The reference refuses operands whose x panes and output exceed
its VMEM budget; the Hopper kernel reads x from global memory, so the port
has no such guard. The wrapper runs the plain version for CPU tensors only;
for CUDA tensors it launches the kernel or raises. ``SELLP_LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.ops._cuda_utils import (check_launch, check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)
from libhpc_tpu_torch.ops.spmv_sell import stripe_walk, x_panes
from libhpc_tpu_torch.sparse._leaves import TensorLeaves

B = 8
LANE = 128
PANE = B * LANE          # 1024 rows/cols per stripe/pane
TPB = 64                 # tile-stream padding multiple

SELLP_LAUNCHES = 0


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclasses.dataclass(frozen=True)
class SELLP(TensorLeaves):
    """Per-row-sourced plane ELL (module docstring).

    lidx packs lane (bits 0-6) and the unit's x sublane jp (bits 7-9)
    per slot; all slots of a tile row share one jp, all rows of a tile
    share one pane."""

    vflat: torch.Tensor   # (n_tiles*B, LANE) f32 value planes
    lidx: torch.Tensor    # (n_tiles*B, LANE) i32 packed jp<<7 | lane
    pane: torch.Tensor    # (n_tiles,) i32 absolute x pane per tile
    sid: torch.Tensor     # (n_tiles,) i32 stripe id per tile
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_stripes: int = dataclasses.field(metadata=dict(static=True))
    n_panes: int = dataclasses.field(metadata=dict(static=True))
    tpb: int = dataclasses.field(default=TPB, metadata=dict(static=True))
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
        """Streamed per SpMV: value + lane-index planes + x + y."""
        return (self.vflat.numel() * 4 + self.lidx.numel() * 4
                + self.n_panes * PANE * 4 + self.n_stripes * PANE * 4)

    def fill_ratio(self, nnz: int) -> float:
        return self.n_tiles * PANE / max(nnz, 1)


def sellp_from_scipy(A, tpb: int = None, device="cuda") -> SELLP:
    """Host-side SELL-P build from any scipy.sparse matrix; the leaves move
    to ``device`` once at the end.

    Per stripe: entries keyed by (target pane, target sublane jp,
    per-position multiplicity); each (key, output-sublane) group is one
    row unit; units group into tiles PER PANE (a tile holds up to 8
    units of one pane, one per output sublane), and each unit's jp is
    packed into bits 7-9 of its lane-index row."""
    import scipy.sparse as sps

    if tpb is None:
        tpb = TPB
    A = sps.csr_matrix(A).astype(np.float32)
    m, n = A.shape
    n_stripes = -(-m // PANE)
    n_panes = -(-n // PANE)
    indptr = A.indptr.astype(np.int64)

    per_stripe = []        # (V, L, pane(T,), s)
    for s in range(n_stripes):
        r0, r1 = s * PANE, min((s + 1) * PANE, m)
        lo, hi = indptr[r0], indptr[r1]
        if lo == hi:
            continue
        cols = A.indices[lo:hi].astype(np.int64)
        vals = A.data[lo:hi]
        rows = np.repeat(np.arange(r0, r1, dtype=np.int64),
                         np.diff(indptr[r0:r1 + 1]))
        pos = rows - r0                      # 0..1023 within stripe
        j_out = pos & 7
        l_out = pos >> 3
        key = ((cols >> 10) << 3) | (cols & 7)      # pane<<3 | jp
        lp = (cols >> 3) & (LANE - 1)
        # multiplicity within (key, pos): two entries of one output row
        # reading the same x row need separate units
        order = np.lexsort((pos, key))
        key_s, pos_s = key[order], pos[order]
        new_run = np.ones(key_s.size, bool)
        new_run[1:] = (key_s[1:] != key_s[:-1]) | (pos_s[1:] != pos_s[:-1])
        run_start = np.maximum.accumulate(
            np.where(new_run, np.arange(key_s.size), 0))
        k_rank = np.arange(key_s.size) - run_start
        kmax = int(k_rank.max()) + 1
        # unit id = (key, k, j_out), ascending = pane-major
        jo = j_out[order]
        unit = (key_s * kmax + k_rank) * 8 + jo
        uniq, unit_of = np.unique(unit, return_inverse=True)
        u_jo = uniq % 8
        u_key = uniq // (8 * kmax)
        u_pane = u_key >> 3
        u_jp = u_key & 7
        # rank of each unit within its (pane, j_out) class; classes are not
        # adjacent in uniq order (j_out interleaves), so rank via lexsort
        ord2 = np.lexsort((uniq, u_jo, u_pane))
        newg = np.ones(uniq.size, bool)
        pp, jj = u_pane[ord2], u_jo[ord2]
        newg[1:] = (pp[1:] != pp[:-1]) | (jj[1:] != jj[:-1])
        gstart = np.maximum.accumulate(
            np.where(newg, np.arange(uniq.size), 0))
        rank = np.empty(uniq.size, np.int64)
        rank[ord2] = np.arange(uniq.size) - gstart
        # tiles per pane = max rank+1 over the pane's units
        pane_vals, pane_inv = np.unique(u_pane, return_inverse=True)
        T_pane = np.zeros(pane_vals.size, np.int64)
        np.maximum.at(T_pane, pane_inv, rank + 1)
        offs = np.concatenate([[0], np.cumsum(T_pane)])
        tile_of_unit = offs[pane_inv] + rank
        T = int(offs[-1])
        V = np.zeros((T, B, LANE), np.float32)
        L = np.zeros((T, B, LANE), np.int32)
        pane_t = np.zeros(T, np.int32)
        pane_t[tile_of_unit] = pane_vals[pane_inv].astype(np.int32)
        # per-slot write: entry -> (tile of its unit, j_out, l_out)
        tile_of = tile_of_unit[unit_of]
        V[tile_of, jo, l_out[order]] = vals[order]
        L[tile_of, jo, l_out[order]] = lp[order]
        # pack each unit's jp into bits 7-9 of its whole index row
        L[tile_of_unit, u_jo, :] |= (u_jp.astype(np.int32) << 7)[:, None]
        per_stripe.append((V, L, pane_t, s))

    n_tiles = max(sum(g[0].shape[0] for g in per_stripe), 1)
    n_pad = -(-n_tiles // tpb) * tpb
    vflat = np.zeros((n_pad, B, LANE), np.float32)
    lflat = np.zeros((n_pad, B, LANE), np.int32)
    pane_f = np.zeros(n_pad, np.int32)
    sid_f = np.zeros(n_pad, np.int32)
    # interleaved tile order (round-robin across stripes, not stripe-major):
    # tile k of every stripe before tile k+1
    units = [(li, si) for si, g in enumerate(per_stripe)
             for li in range(g[0].shape[0])]
    units.sort()
    for t, (li, si) in enumerate(units):
        V, L, p, s = per_stripe[si]
        vflat[t] = V[li]
        lflat[t] = L[li]
        pane_f[t] = p[li]
        sid_f[t] = s
    return SELLP(vflat=_t(vflat.reshape(n_pad * B, LANE)),
                 lidx=_t(lflat.reshape(n_pad * B, LANE)),
                 pane=_t(pane_f), sid=_t(sid_f), shape=(m, n),
                 n_stripes=n_stripes, n_panes=n_panes, tpb=tpb).to(device)


def sellp_out_panes_torch(sp: SELLP, x3: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: (n_stripes * B, LANE) f32 with
    out[8 sid + j, l] += V[j, l] * x3[pane, (L >> 7) & 7, L & 127] for
    L = lidx[j, l], tile by tile."""
    T = sp.n_tiles
    L = sp.lidx.reshape(T, B, LANE).long()
    gx = x3[sp.pane.long()[:, None, None], (L >> 7) & (B - 1),
            L & (LANE - 1)]
    prod = sp.vflat.reshape(T, B, LANE) * gx
    out = torch.zeros((sp.n_stripes, B, LANE), dtype=torch.float32,
                      device=x3.device)
    out.index_add_(0, sp.sid.long(), prod)
    return out.reshape(-1, LANE)


def sellp_out_panes(sp: SELLP, x3: torch.Tensor) -> torch.Tensor:
    """K7: the SELL-P product as (n_stripes * B, LANE) f32 output panes;
    x3 is the x pane array (n_panes, B, LANE)."""
    global SELLP_LAUNCHES
    dev = kernel_device(sp.vflat, sp.lidx, sp.pane, sp.tile_order,
                        sp.tile_ptr, x3)
    if dev.type == "cpu":
        return sellp_out_panes_torch(sp, x3)
    T, S = sp.n_tiles, sp.n_stripes
    check_tensor(sp.vflat, "vflat", dev, (torch.float32,), (T * B, LANE))
    check_tensor(sp.lidx, "lidx", dev, (torch.int32,), (T * B, LANE))
    check_tensor(sp.pane, "pane", dev, (torch.int32,), (T,))
    check_tensor(sp.tile_order, "tile_order", dev, (torch.int32,), (T,))
    check_tensor(sp.tile_ptr, "tile_ptr", dev, (torch.int32,), (S + 1,))
    check_tensor(x3, "x3", dev, (torch.float32,), (sp.n_panes, B, LANE))
    out = torch.empty((S * B, LANE), dtype=torch.float32, device=dev)
    fn = kernel_fn("sellp_spmv_f32", 7, 1)
    with torch.cuda.device(dev):
        rc = fn(sp.vflat.data_ptr(), sp.lidx.data_ptr(), sp.pane.data_ptr(),
                sp.tile_order.data_ptr(), sp.tile_ptr.data_ptr(),
                x3.data_ptr(), out.data_ptr(), S, current_stream_ptr())
    check_launch(rc, "sellp_spmv_f32")
    SELLP_LAUNCHES += 1
    return out


def sellp_spmv(sp: SELLP, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for SELL-P A; x f32 (ncols,) -> f32 (nrows,)."""
    out = sellp_out_panes(sp, x_panes(x, sp.n_panes))
    y = out.reshape(sp.n_stripes, B, LANE).transpose(1, 2).reshape(-1)
    return y[:sp.shape[0]]
