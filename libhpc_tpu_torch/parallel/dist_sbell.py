"""Distributed (row-partitioned) SBELL SpMV: unstructured FEM matrices
across the mesh.

Port of ``libhpc_tpu/parallel/dist_sbell.py``. Each shard owns a
contiguous block of rows and splits its slice of the matrix into

  diag  the column block the shard also owns x for: its SpMV runs on the
        local x while the all_gather of x is in flight;
  offd  every other column (full width): it consumes the gathered x;

and a flat FarBlocks far set (the diag block's far blocks folded in, their
columns shifted to global), applied by the plain ``ops/spmv.py:far_spmv``.
On the card both SBELL products launch the hand-written kernel
``csrc/sbell_spmv.cu`` (no far set fused in): two launches a matvec.

``DistSBELL.from_scipy`` builds the reference's stacked host arrays on
every rank, the chunk statics and bounds of the reference's VMEM planner
included (``ops/spmv_sbell.py:_chunk_plan``; the card's kernel reads x from
global memory and ignores them). ``.shard(mesh)`` keeps this rank's slice
on the host and builds its two SBELL containers once on the device
(``shard_blocks``), so a matvec makes no host sync and the card holds the
shard once. ``shard_matvec`` is the shard-local product of
(this shard's containers, x_local, the gathered x): the SPMD matvec runs it
around its all_gather, and it runs alone for any shard on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.ops import spmv_sbell
from libhpc_tpu_torch.parallel.collectives import all_gather
from libhpc_tpu_torch.parallel.dist_spmv import shard_leaves
from libhpc_tpu_torch.parallel.mesh import mesh_device
from libhpc_tpu_torch.sparse._leaves import TensorLeaves
from libhpc_tpu_torch.sparse.sbell import (FarBlocks, SBELL, STRIPE_ROWS, TPB,
                                           VROWS)


def _unified_chunk_plans(sbs, n_panes: int):
    """The reference's uniform chunk plans across shards: (static, bounds)
    with static = (spc, win, gsteps) shared by every shard and bounds an
    (S, n_chunks, 3) int32 tensor of (g0, stripe_lo, pane_lo); (None, None)
    when the resident path fits VMEM_CAP."""
    sl = sbs[0].n_stripes
    if spmv_sbell._resident_bytes(sl, n_panes) <= spmv_sbell.VMEM_CAP:
        return None, None
    auto = [spmv_sbell._chunk_plan(sb) for sb in sbs]
    # uniform stripes a chunk: the smallest any shard needs
    spc = min(p[0] for p in auto)
    plans = [spmv_sbell._chunk_plan(sb, force_spc=spc) for sb in sbs]
    win = max(p[1] for p in plans)
    gsteps = max(p[2] for p in plans)
    G = sbs[0].n_tiles // sbs[0].tpb
    n_chunks = -(-sl // spc)
    bounds = np.zeros((len(sbs), n_chunks, 3), np.int32)
    for s, p in enumerate(plans):
        for c, (g0, s_lo, p_lo) in enumerate(p[3]):
            # g0 re-clamped for the unified (maybe larger) gsteps
            bounds[s, c] = (min(g0, max(G - gsteps, 0)), s_lo, p_lo)
    return (spc, win, gsteps), torch.from_numpy(bounds)


def _pad_sbell_tiles(sb: SBELL, n_tiles: int) -> SBELL:
    """Zero-pad a shard's tile stream so every shard has the same count
    (zero tiles of stripe 0)."""
    extra = n_tiles - sb.n_tiles
    if extra == 0:
        return sb

    def pad(t, n):
        return torch.cat([t, t.new_zeros((n,) + tuple(t.shape[1:]))])

    return dataclasses.replace(
        sb, vflat=pad(sb.vflat, extra * VROWS), meta=pad(sb.meta, extra),
        pane=pad(sb.pane, extra), sid=pad(sb.sid, extra),
        tile_ptr=None, k_max=None)


def _pad_far(f: FarBlocks | None, nf: int, shape) -> FarBlocks:
    """Uniform-length (maybe empty) far block-COO so shards stack: zero
    blocks aimed at (row 0, col 0), inert under far_spmv's scatter-add."""
    if f is None:
        return FarBlocks(rows=torch.zeros((nf,), dtype=torch.int32),
                         cols=torch.zeros((nf,), dtype=torch.int32),
                         blocks=torch.zeros((nf, 8, 8), dtype=torch.float32),
                         shape=shape)
    extra = nf - f.n_far
    if extra == 0:
        return f
    return FarBlocks(
        rows=torch.cat([f.rows, f.rows.new_zeros(extra)]),
        cols=torch.cat([f.cols, f.cols.new_zeros(extra)]),
        blocks=torch.cat([f.blocks, f.blocks.new_zeros((extra, 8, 8))]),
        shape=shape)


def _real_tiles(vflat: torch.Tensor, meta: torch.Tensor,
                sid: np.ndarray) -> int:
    """Tiles before the padding of a shard's stream. Real tiles are
    stripe-major and the padding restarts at stripe 0, so the last
    decrease of sid ends them. With no decrease every tile is in stripe 0
    (or there is no padding): trailing all-zero tiles are dropped, which
    add nothing, so the kernel's deepest stripe is not the padding's."""
    dec = np.flatnonzero(np.diff(sid.astype(np.int64)) < 0)
    if dec.size:
        return int(dec[-1]) + 1
    if len(sid) == 0 or sid[-1] != 0:
        return len(sid)
    live = ((vflat.reshape(len(sid), -1) != 0).any(dim=1)
            | (meta != 0).any(dim=1)).numpy()
    nz = np.flatnonzero(live)
    return int(nz[-1]) + 1 if nz.size else 0


def _shard_sbell(vflat, meta, pane, sid, shape, n_panes, n_stripes, tpb,
                 device) -> SBELL:
    """One shard's SBELL from its host leaves, its tile offsets over the
    real tiles only (the tile padding of other shards is left out)."""
    sid_np = sid.numpy()
    n_true = _real_tiles(vflat, meta, sid_np)
    ptr = np.searchsorted(sid_np[:n_true], np.arange(n_stripes + 1),
                          side="left").astype(np.int32)
    return SBELL(vflat=vflat, meta=meta, pane=pane, sid=sid, far=None,
                 shape=shape, n_stripes=n_stripes, n_panes=n_panes, tpb=tpb,
                 tile_ptr=torch.from_numpy(ptr),
                 k_max=int(np.diff(ptr).max())).to(device)


@dataclasses.dataclass(frozen=True)
class ShardSBELL(TensorLeaves):
    """One shard's products: the diagonal and off-diagonal SBELL blocks
    (no far set of their own) and the shard's flat far set, or None."""

    diag: SBELL
    offd: SBELL
    far: FarBlocks | None


@dataclasses.dataclass(frozen=True)
class DistSBELL(TensorLeaves):
    """Row-partitioned SBELL, stacked over shards (leading dim = S; 1
    after ``shard``).

    diag_*: the shard's own column block (consumes local x)
    offd_*: all other columns, full width (consumes gathered x)
    """

    diag_vflat: torch.Tensor
    diag_meta: torch.Tensor
    diag_pane: torch.Tensor
    diag_sid: torch.Tensor
    offd_vflat: torch.Tensor
    offd_meta: torch.Tensor
    offd_pane: torch.Tensor
    offd_sid: torch.Tensor
    far_rows: torch.Tensor      # (S, nf) far block-COO (zero-block padded)
    far_cols: torch.Tensor      # (S, nf)
    far_blocks: torch.Tensor    # (S, nf, 8, 8)
    diag_bounds: torch.Tensor   # (S, n_chunks, 3) the reference's chunk
    offd_bounds: torch.Tensor   # bounds ((S, 1, 3) zeros when resident)
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    stripes_local: int = dataclasses.field(metadata=dict(static=True))
    has_far: bool = dataclasses.field(metadata=dict(static=True))
    # (spc, win, gsteps) chunk statics shared by all shards, or None
    diag_chunk: tuple = dataclasses.field(metadata=dict(static=True))
    offd_chunk: tuple = dataclasses.field(metadata=dict(static=True))
    tpb: int = dataclasses.field(default=TPB, metadata=dict(static=True))
    # derived, not in the reference: this rank's ShardSBELL, built once by
    # shard() on the mesh's device
    blocks: ShardSBELL | None = dataclasses.field(
        default=None, metadata=dict(derived=True))

    @property
    def rows_local(self) -> int:
        return self.stripes_local * STRIPE_ROWS

    @staticmethod
    def from_scipy(sp, n_shards: int) -> "DistSBELL":
        """The stacked host arrays (CPU tensors), as the reference's."""
        import scipy.sparse as sps

        sp = sps.csr_matrix(sp)
        nr, nc = sp.shape
        if nr != nc:
            raise ValueError("row partitioning assumes a square matrix")
        stripes_local = -(-nr // (n_shards * STRIPE_ROWS))
        rows_local = stripes_local * STRIPE_ROWS
        n_pad = rows_local * n_shards
        if n_pad != nr:
            sp = sps.csr_matrix((sp.data, sp.indices, sp.indptr),
                                shape=(nr, n_pad))
            sp.resize((n_pad, n_pad))
        nr = nc = n_pad

        diags, offds = [], []
        for s in range(n_shards):
            r0, r1 = s * rows_local, (s + 1) * rows_local
            blk = sp[r0:r1, :].tocsc()
            d = blk[:, r0:r1].tocsr()
            o = sps.hstack(
                [blk[:, :r0], sps.csr_matrix((rows_local, rows_local)),
                 blk[:, r1:]]).tocsr()
            diags.append(SBELL.from_scipy(d, group_far=False, device="cpu"))
            offds.append(SBELL.from_scipy(o, group_far=False, device="cpu"))

        dt = max(sb.n_tiles for sb in diags)
        ot = max(sb.n_tiles for sb in offds)
        diags = [_pad_sbell_tiles(sb, dt) for sb in diags]
        offds = [_pad_sbell_tiles(sb, ot) for sb in offds]
        has_far = any(sb.far is not None for sb in offds + diags)
        # fold any diag far set into the offd one (both consume xg)
        nf_max = 1
        fars = []
        for s in range(n_shards):
            parts = []
            if diags[s].far is not None:
                # diag far block-cols are local: shift them to global
                d = diags[s].far
                parts.append(FarBlocks(
                    rows=d.rows, cols=d.cols + (s * rows_local) // 8,
                    blocks=d.blocks, shape=(rows_local, nc)))
                diags[s] = dataclasses.replace(diags[s], far=None)
            if offds[s].far is not None:
                o = offds[s].far
                parts.append(FarBlocks(rows=o.rows, cols=o.cols,
                                       blocks=o.blocks,
                                       shape=(rows_local, nc)))
            if len(parts) == 2:
                merged = FarBlocks(
                    rows=torch.cat([p.rows for p in parts]),
                    cols=torch.cat([p.cols for p in parts]),
                    blocks=torch.cat([p.blocks for p in parts]),
                    shape=(rows_local, nc))
            elif parts:
                merged = parts[0]
            else:
                merged = None
            fars.append(merged)
            if merged is not None:
                nf_max = max(nf_max, merged.n_far)
        fars = [_pad_far(f, nf_max, (rows_local, nc)) for f in fars]

        diag_chunk, diag_bounds = _unified_chunk_plans(
            diags, rows_local // 1024)
        offd_chunk, offd_bounds = _unified_chunk_plans(offds, nc // 1024)
        if diag_bounds is None:
            diag_bounds = torch.zeros((n_shards, 1, 3), dtype=torch.int32)
        if offd_bounds is None:
            offd_bounds = torch.zeros((n_shards, 1, 3), dtype=torch.int32)

        return DistSBELL(
            diag_vflat=torch.stack([sb.vflat for sb in diags]),
            diag_meta=torch.stack([sb.meta for sb in diags]),
            diag_pane=torch.stack([sb.pane for sb in diags]),
            diag_sid=torch.stack([sb.sid for sb in diags]),
            offd_vflat=torch.stack([sb.vflat for sb in offds]),
            offd_meta=torch.stack([sb.meta for sb in offds]),
            offd_pane=torch.stack([sb.pane for sb in offds]),
            offd_sid=torch.stack([sb.sid for sb in offds]),
            far_rows=torch.stack([f.rows for f in fars]),
            far_cols=torch.stack([f.cols for f in fars]),
            far_blocks=torch.stack([f.blocks for f in fars]),
            diag_bounds=diag_bounds, offd_bounds=offd_bounds,
            shape=(nr, nc), n_shards=n_shards,
            stripes_local=stripes_local, has_far=has_far,
            diag_chunk=diag_chunk, offd_chunk=offd_chunk,
            tpb=diags[0].tpb,
        )

    def shard_blocks(self, s: int, device="cuda") -> ShardSBELL:
        """Shard s's ShardSBELL on `device`, from the stacked host arrays
        (an index into the leading dimension: 0 after shard())."""
        rl, nc, sl = self.rows_local, self.shape[1], self.stripes_local
        diag = _shard_sbell(self.diag_vflat[s].cpu(), self.diag_meta[s].cpu(),
                            self.diag_pane[s].cpu(), self.diag_sid[s].cpu(),
                            (rl, rl), rl // 1024, sl, self.tpb, device)
        offd = _shard_sbell(self.offd_vflat[s].cpu(), self.offd_meta[s].cpu(),
                            self.offd_pane[s].cpu(), self.offd_sid[s].cpu(),
                            (rl, nc), nc // 1024, sl, self.tpb, device)
        far = None
        if self.has_far:
            far = FarBlocks(rows=self.far_rows[s], cols=self.far_cols[s],
                            blocks=self.far_blocks[s],
                            shape=(rl, nc)).to(device)
        return ShardSBELL(diag=diag, offd=offd, far=far)

    def shard(self, mesh, axis: str = "x") -> "DistSBELL":
        """This rank's slice (leading dim 1), with its ShardSBELL built once
        on the mesh's device. The stacked leaves stay on the host: the
        matvec reads only ``blocks``, so the card holds one copy of the
        shard."""
        host = shard_leaves(self, mesh, axis, device="cpu")
        return dataclasses.replace(
            host, blocks=host.shard_blocks(0, mesh_device(mesh)))


def shard_matvec(blocks: ShardSBELL, x_l: torch.Tensor, xg: torch.Tensor,
                 wait=None) -> torch.Tensor:
    """One shard's y = diag @ x_l + offd @ xg + far @ xg, in the
    reference's order. wait(), when given, is called after the diagonal
    product and before xg is read (the all_gather's completion)."""
    from libhpc_tpu_torch.ops.spmv import far_spmv

    y = spmv_sbell.sbell_spmv(blocks.diag, x_l)
    if wait is not None:
        wait()
    y = y + spmv_sbell.sbell_spmv(blocks.offd, xg)
    if blocks.far is not None:
        y = y + far_spmv(blocks.far, xg)
    return y


def dist_sbell_spmv_fn(A: DistSBELL, mesh, axis: str = "x"):
    """This rank's distributed matvec: x_local (rows_local,) -> y_local.

    The all_gather of x is started first; the diagonal block's SBELL
    product (local x) runs while it is in flight; the off-diagonal block
    and the far set consume the gathered x."""
    if A.blocks is None:
        raise ValueError("call .shard(mesh) first")
    blocks = A.blocks

    def matvec(x):
        x_l = x.reshape(-1)
        xg, work = all_gather(x_l, axis, mesh=mesh, async_op=True)
        return shard_matvec(blocks, x_l, xg, work.wait)

    return matvec
