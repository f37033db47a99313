"""SBELL — striped block-ELL, the layout of the main path's SpMV.

Port of ``libhpc_tpu/sparse/sbell.py`` (constants, ``FarBlocks``,
``_group_far``, ``FarPane`` and ``SBELL``). The host builders are the
reference's numpy code line for line, so a container built here from a
given scipy matrix equals the reference's array by array.

Layout (see the reference module for its history):
  * stripes of 128 block-rows (1024 scalar rows); slice k of a stripe
    collects the k-th block of every block-row, so tile slot i IS local
    block-row i.
  * a tile is one (64,128) value plane V[8j+i, slot] = block_slot[i,j]
    plus one (128,) int32 meta row: the x lane in bits 0-6 and the pane
    offset 0..2 from the tile's base pane in bits 7-8.
  * blocks outside their slice's 3-pane window, slices thinner than
    MIN_OCCUPANCY rows and slices past K_CAP go to the FAR set: FarPane
    (stripe-grouped, consumed by the far kernel) or flat FarBlocks.

The TPU tuning environment knobs of the reference (LIBHPC_SBELL_TPB,
LIBHPC_SBELL_TPB_BF16) are not ported: TPB and TPB_BF16 stay as constants
because ``tpb`` decides the tile padding, and the containers must match the
reference's. The port adds derived fields, which the Hopper SpMV kernel
needs (ops/spmv_sbell.py): ``SBELL.tile_ptr``, ``SBELL.k_max`` and
``FarPane.olane``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.sparse._leaves import TensorLeaves

B = 8              # scalar block size
LANE = 128         # slots per tile = local block-rows per stripe
STRIPE_ROWS = B * LANE      # 1024 scalar rows per stripe
PANE_COLS = B * LANE        # 1024 scalar cols per x pane
VROWS = B * B      # 64 value rows per tile (meta rides separately)
TPB = 16           # tile-stream padding multiple for f32 values
TPB_BF16 = 32      # tile-stream padding multiple for 2-byte values
W_PANES = 3        # x panes a tile may span
MIN_OCCUPANCY = 8   # slices thinner than this dissolve into the far set
K_CAP = 32          # max slices per stripe; deeper rows spill to far
FAR_SPS = 8        # far-set stripe padding multiple


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclasses.dataclass(frozen=True)
class FarBlocks(TensorLeaves):
    """Flat block-COO far set: one entry per stored 8x8 block."""

    rows: torch.Tensor    # (nf,) i32 block-row ids (duplicates allowed)
    cols: torch.Tensor    # (nf,) i32 block-col ids
    blocks: torch.Tensor  # (nf, B, B) f32 (or bf16 after astype_values)
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def n_far(self) -> int:
        return self.rows.shape[0]

    @property
    def nnz_stored(self) -> int:
        return self.n_far * B * B

    @property
    def hbm_bytes(self) -> int:
        """Per-SpMV traffic: blocks + 2 index streams + gathered x rows +
        read-modify-write of the touched y rows."""
        bsize = self.blocks.element_size()
        return (self.blocks.numel() * bsize + self.rows.numel() * 8
                + self.n_far * B * 4 + 3 * self.n_far * B * 4)


def _group_far(rows, cols, blocks, n_stripes: int, shape):
    """Build the stripe-grouped pane-plan far set (FarPane), or fall back
    to the flat FarBlocks when one stripe hoards more than LANE far blocks
    or uniform padding would blow memory up >4x (+ slack).

    The grouped arrays carry W_PANES-1 zero GUARD stripes (plus FAR_SPS
    padding) so the far contribution has the near output's guarded shape."""
    nf = rows.shape[0]
    stripe = rows // LANE
    slot = rows % LANE
    counts = np.bincount(stripe, minlength=n_stripes)
    E = int(counts.max()) if nf else 0
    if E == 0 or E > LANE or n_stripes * E > 4 * nf + 4096:
        return FarBlocks(rows=_t(rows.astype(np.int32)),
                         cols=_t(cols.astype(np.int32)),
                         blocks=_t(blocks), shape=shape)
    panes_e = (cols >> 7).astype(np.int64)
    order = np.lexsort((panes_e, stripe))   # stripe-major, pane within
    s_o = stripe[order]
    p_o = panes_e[order]
    pos = np.concatenate([[0], np.cumsum(counts)])[:-1]
    e_o = np.arange(nf) - pos[s_o]          # lane slot within stripe
    # distinct-pane runs (entries are pane-sorted within each stripe)
    newp = np.ones(nf, bool)
    newp[1:] = (s_o[1:] != s_o[:-1]) | (p_o[1:] != p_o[:-1])
    run_id = np.cumsum(newp) - 1            # global run index
    stripe_start = np.ones(nf, bool)
    stripe_start[1:] = s_o[1:] != s_o[:-1]
    # run index of each entry's stripe-first run, propagated forward
    base = np.maximum.accumulate(np.where(stripe_start, run_id, -1))
    d_idx = run_id - base                   # per-stripe distinct-pane rank
    D = int(d_idx.max()) + 1
    E_pad = -(-max(E, 1) // B) * B
    n_g = n_stripes + W_PANES - 1
    n_gp = -(-n_g // FAR_SPS) * FAR_SPS
    ep = np.full((n_gp, LANE), -1, np.int32)
    li = np.zeros((n_gp, LANE), np.int32)
    bt = np.zeros((n_gp, B, B, LANE), np.float32)    # [s, j, i, e]
    oh = np.zeros((n_gp, E_pad, LANE), np.float32)
    panes_t = np.zeros((n_gp, D), np.int32)
    ep[s_o, e_o] = p_o.astype(np.int32)
    li[s_o, e_o] = (cols[order] & (LANE - 1)).astype(np.int32)
    # bt[s, j, i, e] = block_e[i, j]
    bt[s_o, :, :, e_o] = blocks[order].transpose(0, 2, 1)
    oh[s_o, e_o, slot[order]] = 1.0
    panes_t[s_o[newp], d_idx[newp]] = p_o[newp].astype(np.int32)
    return FarPane(panes=_t(panes_t), ep=_t(ep), lidx=_t(li),
                   bt=_t(bt.reshape(n_gp * B * B, LANE)),
                   oh=_t(oh.reshape(n_gp * E_pad, LANE)),
                   shape=shape, n_real=int(nf), n_grouped=n_gp,
                   e_pad=E_pad, d_max=D)


def _olane(oh: torch.Tensor, e_pad: int) -> torch.Tensor:
    """(S_g, LANE) i32: the lane of the 1 in each entry's row of the
    one-hot (S_g * e_pad, LANE) plane, -1 for an all-zero row and past
    e_pad."""
    oh3 = oh.reshape(-1, e_pad, LANE)
    lane = torch.where(oh3.amax(dim=2) > 0, oh3.argmax(dim=2), -1)
    olane = torch.full((oh3.shape[0], LANE), -1, dtype=torch.int32,
                       device=oh.device)
    olane[:, :e_pad] = lane.to(torch.int32)
    return olane


@dataclasses.dataclass(frozen=True)
class FarPane(TensorLeaves):
    """Kernel-ready far set: far blocks grouped by stripe, up to LANE
    entries per stripe, consumed by the SpMV kernel
    (ops/far_sbell.py:far_pane_out_panes, ops/spmv_sbell.py):

      gather   gx[j, e] = x3[ep[s, e], j, lidx[s, e]]  (0 where ep = -1)
      product  prod[i, e] = sum_j bt[64 s + 8 j + i, e] * gx[j, e]
      scatter  out[8 s + i, r] = sum_e prod[i, e] * oh[s e_pad + e, r]

    ``panes`` (the distinct panes of each stripe) is kept for parity with
    the reference; the Hopper kernel gathers at ``ep`` directly, and
    scatters by ``olane`` instead of the one-hot ``oh``."""

    panes: torch.Tensor   # (S_g, D) i32 distinct panes per stripe (0-pad)
    ep: torch.Tensor      # (S_g, LANE) i32 entry's pane (-1 = no entry)
    lidx: torch.Tensor    # (S_g, LANE) i32 entry's x lane
    bt: torch.Tensor      # (S_g*B*B, LANE) f32/bf16: [s,8j+i,e] = blk_e[i,j]
    oh: torch.Tensor      # (S_g*E_pad, LANE) f32 one-hot entry -> out lane
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_real: int = dataclasses.field(metadata=dict(static=True))
    n_grouped: int = dataclasses.field(metadata=dict(static=True))
    e_pad: int = dataclasses.field(metadata=dict(static=True))
    d_max: int = dataclasses.field(metadata=dict(static=True))
    # derived, not in the reference: (S_g, LANE) i32 output lane of each
    # entry (the 1 of its row of oh), -1 where there is none; read by the
    # Hopper kernel in place of oh; built from oh once
    olane: torch.Tensor | None = dataclasses.field(
        default=None, metadata=dict(derived=True))

    def __post_init__(self):
        if self.olane is None:
            object.__setattr__(self, "olane", _olane(self.oh, self.e_pad))

    @property
    def n_far(self) -> int:
        return self.n_real

    @property
    def nnz_stored(self) -> int:
        return self.n_far * B * B

    @property
    def hbm_bytes(self) -> int:
        """Per-SpMV traffic: the streamed plan arrays + the guarded output
        add (read+write). x is counted by SBELL.hbm_bytes."""
        bsize = self.bt.element_size()
        return (self.bt.numel() * bsize + self.oh.numel() * 4
                + self.ep.numel() * 4 + self.lidx.numel() * 4
                + self.panes.numel() * 4
                + 2 * self.n_grouped * B * LANE * 4)


def _tile_ptr(sid: np.ndarray, n_stripes: int) -> np.ndarray:
    """(n_stripes+1,) i32 CSR-style offsets of each stripe's tiles.

    Real tiles are stripe-major (sid non-decreasing); only the tpb padding
    tail restarts at sid 0, so the last decrease ends the real tiles. An
    all-stripe-0 matrix has no decrease: its padding tiles (zero values)
    then fall inside stripe 0's range, where they add nothing."""
    sid = sid.astype(np.int64)
    dec = np.flatnonzero(np.diff(sid) < 0)
    n_true = int(dec[-1]) + 1 if dec.size else len(sid)
    return np.searchsorted(sid[:n_true], np.arange(n_stripes + 1),
                           side="left").astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SBELL(TensorLeaves):
    """Striped block-ELL matrix (see module docstring for the layout)."""

    vflat: torch.Tensor   # (n_tiles*VROWS, 128) f32/bf16 value planes
    meta: torch.Tensor    # (n_tiles, 128) i32 col_local per slot
    pane: torch.Tensor    # (n_tiles,) i32 base x-pane per tile
    sid: torch.Tensor     # (n_tiles,) i32 stripe id per tile
    far: object           # FarBlocks, FarPane, or None
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_stripes: int = dataclasses.field(metadata=dict(static=True))
    n_panes: int = dataclasses.field(metadata=dict(static=True))
    tpb: int = dataclasses.field(default=TPB, metadata=dict(static=True))
    # derived, not in the reference: (n_stripes+1,) i32 offsets of each
    # stripe's real tiles, and the most tiles a stripe holds, read by the
    # SpMV kernel; built from sid once
    tile_ptr: torch.Tensor | None = dataclasses.field(
        default=None, metadata=dict(derived=True))
    k_max: int | None = dataclasses.field(
        default=None, metadata=dict(derived=True))

    def __post_init__(self):
        if self.tile_ptr is None:
            ptr = _tile_ptr(self.sid.cpu().numpy(), self.n_stripes)
            object.__setattr__(self, "tile_ptr",
                               _t(ptr).to(self.sid.device))
        if self.k_max is None:
            ptr = self.tile_ptr.cpu().numpy()
            object.__setattr__(self, "k_max",
                               int(np.diff(ptr).max()) if len(ptr) > 1
                               else 0)

    @property
    def n_tiles(self) -> int:
        return self.vflat.shape[0] // VROWS

    @property
    def nnz_stored(self) -> int:
        """Stored scalar slots (64 per block slot, incl. padding)."""
        far = self.far.nnz_stored if self.far is not None else 0
        return self.n_tiles * LANE * B * B + far

    @property
    def hbm_bytes(self) -> int:
        """Bytes streamed per SpMV: near value+meta planes + the far set's
        own traffic + x + y. The value-plane term uses the stored itemsize
        (2 for the bf16 variant)."""
        far = self.far.hbm_bytes if self.far is not None else 0
        vsize = self.vflat.element_size()
        return (self.vflat.numel() * vsize + self.meta.numel() * 4
                + self.n_panes * PANE_COLS * 4
                + self.n_stripes * STRIPE_ROWS * 4
                + far)

    def astype_values(self, dtype: torch.dtype, tpb: int | None = None
                      ) -> "SBELL":
        """Value-stream precision variant: cast the stored values (near
        planes and far blocks; FarPane's one-hot stays f32) to `dtype`. The
        kernels still accumulate in f32, so the result equals the
        `dtype`-quantized operator applied in f32.

        tpb defaults to TPB_BF16 for 2-byte dtypes, as in the reference;
        pass tpb explicitly to override."""
        far = self.far
        if isinstance(far, FarPane):
            far = dataclasses.replace(far, bt=far.bt.to(dtype))
        elif far is not None:
            far = dataclasses.replace(far, blocks=far.blocks.to(dtype))
        out = dataclasses.replace(self, vflat=self.vflat.to(dtype), far=far)
        if tpb is None and dtype.itemsize == 2:
            tpb = TPB_BF16
        if tpb is not None and tpb != self.tpb:
            out = out.retile(tpb)
        return out

    def retile(self, tpb: int) -> "SBELL":
        """Re-pad the tile stream to a multiple of `tpb` (extra tiles are
        zero-valued, stripe 0 — inert)."""
        n_tiles = self.n_tiles
        extra = -(-n_tiles // tpb) * tpb - n_tiles

        def pad(t, n):
            return torch.cat([t, t.new_zeros((n,) + tuple(t.shape[1:]))])

        return dataclasses.replace(
            self,
            vflat=pad(self.vflat, extra * VROWS),
            meta=pad(self.meta, extra),
            pane=pad(self.pane, extra),
            sid=pad(self.sid, extra),
            tpb=tpb)

    def fill_ratio(self, nnz: int) -> float:
        return self.nnz_stored / max(nnz, 1)

    @property
    def far_fraction(self) -> float:
        """Fraction of stored blocks routed to the far path."""
        if self.far is None:
            return 0.0
        return self.far.n_far / max(self.far.n_far + self.n_tiles * LANE, 1)

    @staticmethod
    def from_scipy(A, group_far: bool = True, tpb: int | None = None,
                   device="cuda") -> "SBELL":
        """Host-side construction from any scipy.sparse matrix; the leaves
        move to ``device`` once at the end.

        group_far=False keeps the far set as flat FarBlocks. tpb overrides
        the tile-stream padding multiple (default TPB)."""
        if tpb is None:
            tpb = TPB
        import scipy.sparse as sps

        A = sps.csr_matrix(A)
        m, n = A.shape
        n_stripes = -(-m // STRIPE_ROWS)
        n_panes = -(-n // PANE_COLS)
        mp, np_ = n_stripes * STRIPE_ROWS, n_panes * PANE_COLS
        if (mp, np_) != (m, n):
            A = sps.csr_matrix((A.data, A.indices, A.indptr), shape=(m, np_))
            A.resize((mp, np_))
        bsr = A.tobsr((B, B))
        blocks = np.ascontiguousarray(bsr.data, dtype=np.float32)
        bcols = bsr.indices.astype(np.int64)
        indptr = bsr.indptr.astype(np.int64)

        tiles = []                 # (v (64,128), meta (128,), pane, sid)
        far_br, far_bc, far_blk = [], [], []

        def to_far(rows_g, cols, blks):
            far_br.append(rows_g)
            far_bc.append(cols)
            far_blk.append(blks)

        for s in range(n_stripes):
            r0, r1 = s * LANE, (s + 1) * LANE
            lo, hi = indptr[r0], indptr[r1]
            if lo == hi:
                continue
            counts = np.diff(indptr[r0:r1 + 1])
            K = int(counts.max())
            brl = np.repeat(np.arange(LANE, dtype=np.int64), counts)
            bc = bcols[lo:hi]
            blk = blocks[lo:hi]
            # per block-row, blocks sorted by column (CSR/BSR guarantee):
            # slice k = the k-th block of every row that has one
            kpos = np.concatenate(
                [np.arange(c, dtype=np.int64) for c in counts]) \
                if len(counts) else np.empty(0, np.int64)
            for k in range(K):
                sel = kpos == k
                rows_k = brl[sel]
                cols_k = bc[sel]
                blks_k = blk[sel]
                if k >= K_CAP or len(rows_k) < MIN_OCCUPANCY:
                    to_far(s * LANE + rows_k, cols_k, blks_k)
                    continue
                # pane window: pick the base covering the most blocks
                panes = cols_k >> 7
                cands = (int(panes.min()), max(int(panes.max()) - W_PANES
                                               + 1, 0))
                best, best_in = cands[0], -1
                for p in set(cands):
                    nin = int(((panes >= p)
                               & (panes < p + W_PANES)).sum())
                    if nin > best_in:
                        best, best_in = p, nin
                inw = (panes >= best) & (panes < best + W_PANES)
                if (~inw).any():
                    to_far(s * LANE + rows_k[~inw], cols_k[~inw],
                           blks_k[~inw])
                    rows_k, cols_k, blks_k = (rows_k[inw], cols_k[inw],
                                              blks_k[inw])
                if len(rows_k) < MIN_OCCUPANCY:
                    to_far(s * LANE + rows_k, cols_k, blks_k)
                    continue
                v = np.zeros((B * B, LANE), np.float32)
                # V[8j+i, slot=local block-row] = block[i, j]
                v[:, rows_k] = blks_k.transpose(2, 1, 0).reshape(B * B, -1)
                meta = np.zeros(LANE, np.int32)
                meta[rows_k] = (cols_k - (best << 7)).astype(np.int32)
                tiles.append((v, meta, best, s))

        n_tiles = max(len(tiles), 1)
        n_tiles_pad = -(-n_tiles // tpb) * tpb
        vflat = np.zeros((n_tiles_pad, VROWS, LANE), np.float32)
        metas = np.zeros((n_tiles_pad, LANE), np.int32)
        pane = np.zeros(n_tiles_pad, np.int32)
        sid = np.zeros(n_tiles_pad, np.int32)
        for t, (v, meta, p, s) in enumerate(tiles):
            vflat[t] = v
            metas[t] = meta
            pane[t], sid[t] = p, s

        far = None
        if far_br:
            rows_f = np.concatenate(far_br).astype(np.int64)
            cols_f = np.concatenate(far_bc).astype(np.int64)
            blk_f = np.concatenate(far_blk, dtype=np.float32)
            if group_far:
                far = _group_far(rows_f, cols_f, blk_f, n_stripes,
                                 (mp, np_))
            else:
                far = FarBlocks(rows=_t(rows_f.astype(np.int32)),
                                cols=_t(cols_f.astype(np.int32)),
                                blocks=_t(blk_f), shape=(mp, np_))

        return SBELL(
            vflat=_t(vflat.reshape(n_tiles_pad * VROWS, LANE)),
            meta=_t(metas),
            pane=_t(pane),
            sid=_t(sid),
            far=far,
            shape=(m, n),
            n_stripes=n_stripes,
            n_panes=n_panes,
            tpb=tpb,
        ).to(device)
