"""Radix sort — libHPC's flagship, and its count -> scan -> scatter pipeline.

Port of ``libhpc_tpu/ops/sort.py``. The reference has no Pallas kernel
here, so this module is plain torch, as the reference is plain XLA:

  sort_u32 / radix_sort  — production path: ``torch.sort`` (the reference's
                           is ``lax.sort``)
  argsort_u32            — stable argsort: (sorted, int32 order)
  is_sorted
  radix_sort_pipeline    — the explicit multi-pass LSD radix sort built from
                           its stages ``digit_of``, ``tile_histograms``
                           (the port's ``local_histogram``),
                           ``global_base_from_local``,
                           ``tile_offsets_from_local`` and
                           ``_rank_within_tiles``
  bitonic_sort           — the bitonic network in vectorized torch ops

u32 keys. torch's ``uint32`` is a shell dtype: it views, copies and
converts to numpy, but shifts, compares and sorts are not implemented for
it everywhere. So keys travel as int32 bit patterns (``u32_bits``), order
is taken in the sign-flipped domain (``x ^ 0x80000000`` orders as int32
exactly as x orders as u32), digits are taken in int64 (a logical shift),
and results come back as ``torch.uint32`` views (``as_u32``), as the
reference returns uint32. Inputs may be torch tensors of any integer dtype
(taken mod 2^32, as the reference's ``astype(uint32)``) or numpy arrays. A
torch tensor is sorted on its own device; a numpy array is moved to
``device`` (default ``"cuda"``, as the reference's arrays land on its
accelerator), so ``device="cpu"`` asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from libhpc_tpu_torch.ops._cuda_utils import as_tensor, cdiv
from libhpc_tpu_torch.ops.histogram import local_histogram

TILE = 2048  # elements per tile in the pipeline variant
FLIP = -(2 ** 31)          # sign-bit flip: u32 order <-> i32 order
U32_MAX_BITS = -1          # 0xFFFFFFFF as an int32 bit pattern
RANK_BATCH_ELEMS = 1 << 24  # one-hot elements per batch of tiles


def u32_bits(x, device="cuda") -> torch.Tensor:
    """The u32 value of each element of x, as an int32 bit pattern; a numpy
    x is moved to ``device``, a tensor stays where it is."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(
            np.ascontiguousarray(x).astype(np.uint32).view(np.int32)
        ).to(device)
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype == torch.int32:
        return x
    return (x.to(torch.int64) & 0xFFFFFFFF).to(torch.int32)


def as_u32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> the torch.uint32 view of the same memory."""
    return bits.view(torch.uint32)


def sort_u32(x, *, device="cuda") -> torch.Tensor:
    """Sort uint32 ascending — production path (torch.sort)."""
    s = torch.sort(u32_bits(x, device) ^ FLIP).values
    return as_u32(s ^ FLIP)


# public alias matching the reference API name (radix_sort_cpu.hpp:325-332)
radix_sort = sort_u32


def argsort_u32(x, *, device="cuda"):
    """Stable ascending argsort; returns (sorted uint32, int32 order)."""
    s, order = torch.sort(u32_bits(x, device) ^ FLIP, stable=True)
    return as_u32(s ^ FLIP), order.to(torch.int32)


def is_sorted(x, *, device="cuda") -> torch.Tensor:
    """0-d bool tensor: x is non-decreasing (uint32 compared as u32)."""
    x = as_tensor(x, device)
    if x.dtype == torch.uint32:
        x = x.view(torch.int32) ^ FLIP
    if x.shape[0] <= 1:
        return torch.tensor(True, device=x.device)
    return torch.all(x[1:] >= x[:-1])


# ---------------------------------------------------------------------------
# The explicit count→scan→scatter pipeline (parity path)
# ---------------------------------------------------------------------------


def digit_of(x, shift, bits_per_pass: int = 8, *,
             device="cuda") -> torch.Tensor:
    """Extract the radix digit — stage 0 of the pipeline. A logical shift
    of the u32 value (in int64), so digits reaching bit 31 are right."""
    mask = (1 << bits_per_pass) - 1
    v = u32_bits(x, device).to(torch.int64) & 0xFFFFFFFF
    return ((v >> int(shift)) & mask).to(torch.int32)


def tile_histograms(digits: torch.Tensor, n_bins: int = 256,
                    tile: int = TILE) -> torch.Tensor:
    """local[tile][bin] — the reference's kernel_local_histogram stage
    (cuda_local_histogram.cuh:43-92). Padding (digit == n_bins) not counted."""
    return local_histogram(digits, n_bins=n_bins, tile=tile)


def global_base_from_local(local_hist: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of per-bin totals — the reference's global-reduce +
    exclusive_scan stages (cuda_radix_sort_v4.cu:142-183)."""
    totals = local_hist.sum(dim=0, dtype=torch.int32)
    return torch.cumsum(totals, dim=0, dtype=torch.int32) - totals


def tile_offsets_from_local(local_hist: torch.Tensor) -> torch.Tensor:
    """offset[tile][bin]: elements of the same bin in *earlier tiles* — an
    exclusive scan down the tile axis (cuda_radix_sort_v4.cu:193)."""
    return torch.cumsum(local_hist, dim=0, dtype=torch.int32) - local_hist


def _rank_within_tiles(digits: torch.Tensor, n_bins: int = 256,
                       tile: int = TILE) -> torch.Tensor:
    """rank[i]: occurrences of digit[i] earlier in i's tile — a per-tile
    one-hot cumulative count (cuda_radix_scatter.cuh:60-75), over batches
    of tiles so that the one-hot holds at most about RANK_BATCH_ELEMS
    elements (the reference's lax.map over tiles bounds it the same way)."""
    n = digits.shape[0]
    n_tiles = max(1, cdiv(n, tile))
    # pad with out-of-range digit so pad elements rank into nothing real
    dp = torch.full((n_tiles * tile,), n_bins, dtype=torch.int32,
                    device=digits.device)
    dp[:n] = digits
    dt = dp.reshape(n_tiles, tile)
    bins = torch.arange(n_bins, dtype=torch.int32, device=digits.device)
    step = max(1, RANK_BATCH_ELEMS // (tile * n_bins))
    ranks = torch.empty_like(dt)
    for t0 in range(0, n_tiles, step):
        d = dt[t0:t0 + step]
        onehot = (d[:, :, None] == bins).to(torch.int32)
        excl = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
        ranks[t0:t0 + step] = torch.gather(
            excl, 2, (d % n_bins).to(torch.int64)[:, :, None])[:, :, 0]
    return ranks.reshape(-1)[:n]


def radix_sort_pipeline(x, bits_per_pass: int = 8, tile: int = TILE, *,
                        device="cuda") -> torch.Tensor:
    """Full multi-pass LSD radix sort via the explicit pipeline.

    Per pass (SURVEY.md §3.2's count→scan→scatter skeleton):
      1. digits        = (x >> shift) & mask
      2. local[t][b]   = tile histograms
      3. base[b]       = exclusive scan of global bin totals
      4. offs[t][b]    = per-bin exclusive scan across tiles
      5. rank[i]       = stable rank within (tile, bin)
      6. pos[i]        = base[digit] + offs[tile][digit] + rank[i]
      7. scatter       = out[pos] = x
    """
    x = u32_bits(x, device)
    n = x.shape[0]
    if n <= 1:
        return as_u32(x)
    n_bins = 1 << bits_per_pass
    n_passes = cdiv(32, bits_per_pass)
    tile_ids = torch.arange(n, dtype=torch.int64, device=x.device) // tile

    for p in range(n_passes):
        digits = digit_of(x, p * bits_per_pass, bits_per_pass)
        local = tile_histograms(digits, n_bins=n_bins, tile=tile)
        base = global_base_from_local(local)
        offs = tile_offsets_from_local(local)
        rank = _rank_within_tiles(digits, n_bins=n_bins, tile=tile)
        d = digits.to(torch.int64)
        pos = base[d] + offs[tile_ids, d] + rank
        out = torch.zeros_like(x)
        out[pos.to(torch.int64)] = x
        x = out
    return as_u32(x)


# ---------------------------------------------------------------------------
# Bitonic sort network (vectorized butterfly stages)
# ---------------------------------------------------------------------------


def bitonic_sort(x, *, device="cuda") -> torch.Tensor:
    """Full bitonic sort network in vectorized torch ops.

    Every compare-exchange stage at distance d is a reshape to
    (n/2d, 2, d) + min/max + direction select; log²(n)/2 stages. Pads to a
    power of two with UINT32_MAX; compares in the sign-flipped domain.
    """
    x = u32_bits(x, device)
    n = x.shape[0]
    if n <= 1:
        return as_u32(x)
    k = max(1, (n - 1).bit_length())
    n_pad = 1 << k
    xp = torch.full((n_pad,), U32_MAX_BITS ^ FLIP, dtype=torch.int32,
                    device=x.device)
    xp[:n] = x ^ FLIP

    for k2 in range(1, k + 1):          # bitonic run length 2^k2
        run = 1 << k2
        for sub in range(k2 - 1, -1, -1):
            d = 1 << sub
            v = xp.reshape(n_pad // (2 * d), 2, d)
            blk = torch.arange(n_pad // (2 * d), device=x.device)
            # ascending iff the element's position / run is even
            asc = (((blk * 2 * d) // run) % 2 == 0)[:, None]
            a, b = v[:, 0, :], v[:, 1, :]
            mn, mx = torch.minimum(a, b), torch.maximum(a, b)
            v = torch.stack([torch.where(asc, mn, mx),
                             torch.where(asc, mx, mn)], dim=1)
            xp = v.reshape(n_pad)
    return as_u32(xp[:n] ^ FLIP)
