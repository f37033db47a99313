"""Histogram / binning: the count stage of the radix pipeline.

Port of ``libhpc_tpu/ops/histogram.py``:

  ``histogram(x, n_bins)``             global histogram (plain torch)
  ``local_histogram(x, n_bins, tile)`` per-tile histograms (n_tiles, n_bins),
                                       the 'local' stage of the radix pipeline
  ``histogram_pallas(x, n_bins)``      wraps the hand-written CUDA kernel
                                       ``csrc/histogram.cu`` (K15, the port of
                                       ``histogram.py:_hist_kernel``);
                                       ``histogram_pallas_torch`` is its plain
                                       version (``torch.bincount``)

Values outside ``[0, n_bins)`` are not counted, and neither is padding
(the reference pads with the out-of-range bin ``n_bins``). Counts are int32,
as in the reference.

The TPU kernel carries a VMEM accumulator along its sequential grid. Hopper
blocks run in no order, so the kernel keeps one shared-memory histogram per
block, adds into it with shared atomics, and adds each block's nonzero bins
into the zeroed output with one global atomic per bin (the design of
libHPC's ``kernel_local_histogram``). The wrapper raises for an ``n_bins``
whose histogram does not fit a block's shared memory (``MAX_KERNEL_BINS``),
and for a CUDA tensor that is not a contiguous 1-D int32 array; CPU tensors
take the plain version. ``HIST_LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.ops._cuda_utils import (cdiv, check_launch, check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)

LANE = 128
SUBLANES = 8
TILE = SUBLANES * LANE
MAX_KERNEL_BINS = 1 << 15   # 128 KB of shared memory per block

HIST_LAUNCHES = 0


def _in_range(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    x = x.reshape(-1).to(torch.int64)
    return x[(x >= 0) & (x < n_bins)]


def histogram(x: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """Global histogram of integer values in [0, n_bins) -> (n_bins,) int32."""
    return torch.bincount(_in_range(x, n_bins),
                          minlength=n_bins).to(torch.int32)


def local_histogram(x: torch.Tensor, n_bins: int = 256,
                    tile: int = TILE) -> torch.Tensor:
    """Per-tile histograms: (n_tiles, n_bins) int32, n_tiles = max(1,
    ceil(n / tile)). Element i counts in tile i // tile; the ragged last
    tile's padding is not counted."""
    x = x.reshape(-1).to(torch.int64)
    n_tiles = max(1, cdiv(x.shape[0], tile))
    tid = torch.arange(x.shape[0], device=x.device) // tile
    keep = (x >= 0) & (x < n_bins)
    keys = tid[keep] * n_bins + x[keep]
    counts = torch.bincount(keys, minlength=n_tiles * n_bins)
    return counts.reshape(n_tiles, n_bins).to(torch.int32)


def histogram_pallas_torch(x: torch.Tensor, n_bins: int = 256
                           ) -> torch.Tensor:
    """Plain version of K15: torch.bincount over the in-range values."""
    return histogram(x, n_bins)


def histogram_pallas(x: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """K15: (n_bins,) int32 histogram of x, out-of-range values not
    counted. CUDA tensors must be contiguous 1-D int32."""
    global HIST_LAUNCHES
    dev = kernel_device(x)
    if dev.type == "cpu":
        return histogram_pallas_torch(x, n_bins)
    check_tensor(x, "x", dev, (torch.int32,), (x.numel(),))
    if not 1 <= n_bins <= MAX_KERNEL_BINS:
        raise ValueError(f"n_bins {n_bins}: the kernel holds 1..."
                         f"{MAX_KERNEL_BINS} bins in shared memory")
    if x.numel() >= 1 << 31:
        raise ValueError(f"x: {x.numel()} elements, the kernel takes < 2^31")
    out = torch.zeros(n_bins, dtype=torch.int32, device=dev)
    fn = kernel_fn("histogram_i32", 2, 2)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), n_bins,
                current_stream_ptr())
    check_launch(rc, "histogram_i32")
    HIST_LAUNCHES += 1
    return out
