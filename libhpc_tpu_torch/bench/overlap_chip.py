"""Single-chip memory/compute overlap sweep.

Port of ``libhpc_tpu/bench/overlap_chip.py``, the analog of libHPC's
stream-overlap compute-intensity sweep
(lib/gpu/transfer_overlap_testsuite/src/cuda_tut_transfer_overlap.cu:
144-218): one kernel streams (ROWS, 128) float32 blocks (1 MB) from device
memory and runs w dependent rounds of multiply-add on every element. If
loads overlap the arithmetic, the time per block is max(t_mem, w * t_unit);
if they serialized, it would be t_mem + w * t_unit.

  _sweep_step(x, w)   the sweep through the hand-written CUDA kernel
                      ``csrc/overlap_chip.cu`` (K20, the port of
                      ``overlap_chip.py:_kernel``); ``_sweep_step_torch``
                      is its plain version
  run(mb=512)         t(w) for w in WS, the compute unit t_unit from the
                      slope between the two largest w, the w* whose compute
                      w * t_unit is nearest t(0), and
                      overlap_efficiency = (t(0) + C - t(w*)) / min(t(0), C)
                      with C = w* t_unit (1.0 = perfect overlap, 0.0 =
                      serial); prints and returns one JSON record

On an H100 the compute unit is the time of one round of 2 flops over a
1 MB block. The tail slope between w = 32 and 64 measures it only where
both points lie past the ridge (67 TFLOP/s over 3.35 TB/s = 20 flop a
byte, so w near 40): where t(32) is still memory-bound, the slope
underestimates the unit. The formulas are the reference's, kept so that
the two records compare.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. ``SWEEP_LAUNCHES`` counts kernel launches.

Run: python -m libhpc_tpu_torch.bench.overlap_chip
"""

from __future__ import annotations

import json

import torch

from libhpc_tpu_torch.bench.harness import time_iterated
from libhpc_tpu_torch.ops._cuda_utils import (check_launch, check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)

ROWS = 2048          # rows per block: 1 MB
LANE = 128
WS = (0, 1, 2, 4, 8, 16, 32, 64)

SWEEP_LAUNCHES = 0


def _sweep_step_torch(x: torch.Tensor, w: int) -> torch.Tensor:
    """Plain version of K20: the first (x.shape[0] // ROWS) blocks of x,
    w rounds of acc = acc * 1.000001 + v, every row r of a block summed
    into output row r % 8."""
    steps = x.shape[0] // ROWS
    v = x[:steps * ROWS].reshape(steps, ROWS // 8, 8, LANE)
    acc = v
    for _ in range(w):
        acc = acc * 1.000001 + v
    return acc.sum(dim=1).reshape(steps * 8, LANE)


def _sweep_step(x: torch.Tensor, w: int) -> torch.Tensor:
    """K20: (steps * 8, 128) float32 sweep output of x, a (rows, 128)
    float32 tensor read as rows // ROWS blocks (trailing rows ignored, as
    the reference's grid ignores them)."""
    global SWEEP_LAUNCHES
    if x.ndim != 2 or x.shape[1] != LANE:
        raise ValueError(f"_sweep_step: (rows, {LANE}) input, got shape "
                         f"{tuple(x.shape)}")
    if w < 0:
        raise ValueError(f"_sweep_step: w = {w} < 0")
    dev = kernel_device(x)
    if dev.type == "cpu":
        return _sweep_step_torch(x, w)
    steps = x.shape[0] // ROWS
    x = x[:steps * ROWS]
    check_tensor(x, "x", dev, (torch.float32,), (steps * ROWS, LANE))
    if x.data_ptr() % 16:
        raise ValueError("_sweep_step: x is not 16-byte aligned")
    if steps >= 1 << 31 or w >= 1 << 31:
        raise ValueError(f"_sweep_step: {steps} blocks, w = {w}; the kernel "
                         "takes values < 2^31")
    out = torch.empty((steps * 8, LANE), dtype=torch.float32, device=dev)
    if steps == 0:
        return out
    fn = kernel_fn("overlap_sweep_f32", 2, 2)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), out.data_ptr(), steps, w, current_stream_ptr())
    check_launch(rc, "overlap_sweep_f32")
    SWEEP_LAUNCHES += 1
    return out


def _time_sweep(x, w, iters=96, small=12, reps=4):
    """Delta-method seconds of one sweep over all of x. Each application
    reads x anew (eager torch neither hoists nor fuses the call); its
    output rides through as the carry."""
    return time_iterated(lambda _, v: _sweep_step(v, w), x[:8], iters=iters,
                         iters_small=small, reps=reps, operand=x)


def run(mb: int = 512, *, device="cuda"):
    steps = mb * 1024 * 1024 // (ROWS * LANE * 4)
    x = torch.ones((steps * ROWS, LANE), dtype=torch.float32, device=device)
    nbytes = x.numel() * 4

    times = {}
    for w in WS:
        times[w] = _time_sweep(x, w) / steps
    t0 = times[WS[0]]
    # compute-unit time from the compute-bound tail slope
    t_unit = (times[WS[-1]] - times[WS[-2]]) / (WS[-1] - WS[-2])
    # pick W* where estimated compute is closest to the memory floor
    wstar = min(WS[1:], key=lambda w: abs(w * t_unit - t0))
    c = wstar * t_unit
    eff = (t0 + c - times[wstar]) / min(t0, c) if min(t0, c) > 0 else 0.0
    out = {
        "bench": "singlechip_dma_compute_overlap",
        "block_mb": ROWS * LANE * 4 / 1e6,
        "stream_gb_per_s": round(nbytes / (t0 * steps) / 1e9, 1),
        "us_per_step": {str(w): round(t * 1e6, 3) for w, t in times.items()},
        "compute_unit_us": round(t_unit * 1e6, 4),
        "w_star": wstar,
        "overlap_efficiency": round(float(eff), 3),
        "platform": "gpu" if x.is_cuda else x.device.type,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    run()
