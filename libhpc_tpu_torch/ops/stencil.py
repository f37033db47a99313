"""Ghost-cell stencils.

Port of ``libhpc_tpu/ops/stencil.py``, the re-expression of libHPC's
stencil-blur ladder (tests/test_hpc_benchmark/test_hpc_benchmark.cpp:
354-601: an 8192 x 8192, radius-8 box blur) and of the ghost cells of
HPCHighDimensionFlatArray:

  box_sum_halo, poisson5_halo, poisson7_halo
                 the shared ghost-cell stencils on a HaloArray (plain torch)
  box_sum_1d, blur_x, blur_y, blur2d
                 zero-halo box sums in the reference's running-sum form
                 (cumsum differences: O(N) whatever the radius; plain torch)
  poisson5_apply, poisson7_apply
                 matrix-free 5- and 7-point Poisson operators, equal to
                 ``bench.matrices.poisson2d`` / ``poisson3d`` applied to u
  blur2d_pallas(a, radius=8, tile_m=None)
                 the 2-D box sum through the hand-written CUDA kernel
                 ``csrc/blur2d.cu`` (K19, the port of
                 ``stencil.py:_blur2d_kernel``); ``blur2d_pallas_torch`` is
                 its plain version, which adds in the kernel's order

K19 is a box *sum* of radius r with a zero halo, float32. The reference
zero-pads a copy of the input and takes cumsum differences along x, then
y, in VMEM row tiles; the kernel walks column strips down the rows, brings
each stage of rows in with the cells outside the input as zero (no padded
copy) and adds the 2r + 1 terms of each output directly, x then y, in
registers. So the two round differently: the reference's x cumsum spans a
whole padded row, and its error grows with the width; the kernel's does
not. ``tile_m`` keeps the reference's signature: its automatic size
follows the TPU's 16 MB VMEM budget, and it sets no tiling on the card.

The kernel has two load modes, both hand-written: a TMA copy of each stage
from a tensor map of the input (which needs a 16-byte-aligned input whose
rows are a multiple of 16 bytes), and 4-byte asynchronous copies by every
thread for any other input. ``blur_plan`` picks the mode and sizes the
stage from (m, n, r, data_ptr).

Dispatch: CPU tensors take the plain version; CUDA tensors launch the kernel
or raise. A numpy input goes to ``device`` (default ``"cuda"``).
``BLUR_LAUNCHES`` counts kernel launches, ``BLUR_TMA_LAUNCHES`` and
``BLUR_PLAIN_LAUNCHES`` those of each load mode.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from libhpc_tpu_torch.containers import HaloArray
from libhpc_tpu_torch.ops._cuda_utils import (as_tensor, check_launch,
                                              check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)

MAX_KERNEL_RADIUS = 64   # a stage's box (128 + 2r columns) fits a TMA box

BLUR_LAUNCHES = 0
BLUR_TMA_LAUNCHES = 0
BLUR_PLAIN_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Shared ghost-cell stencil kernels: HaloArray -> interior-shaped result
# ---------------------------------------------------------------------------


def box_sum_halo(h: HaloArray, radius: int, axis: int) -> torch.Tensor:
    """Sliding-window sum of width 2r+1 along `axis`; needs halo >= r+1 low
    and >= r high on that axis (running-sum form)."""
    r = radius
    n = h.interior_shape[axis]
    a0 = h.lo[axis] - r - 1   # padded-coord start of the window we use
    sl = [slice(l, l + s) for l, s in zip(h.lo, h.interior_shape)]
    sl[axis] = slice(a0, a0 + n + 2 * r + 1)
    w = h.data[tuple(sl)]
    # jnp.cumsum keeps the input's dtype (bool counts in int32); integer
    # sums wrap as the reference's do
    c = torch.cumsum(w, dim=axis,
                     dtype=torch.int32 if w.dtype == torch.bool else w.dtype)
    return (c.narrow(axis, 2 * r + 1, n) - c.narrow(axis, 0, n))


def poisson5_halo(h: HaloArray) -> torch.Tensor:
    """Matrix-free 5-point operator on a (1,1)-haloed 2D field."""
    return (4.0 * h.interior
            - h.shift((-1, 0)) - h.shift((1, 0))
            - h.shift((0, -1)) - h.shift((0, 1)))


def poisson7_halo(h: HaloArray) -> torch.Tensor:
    """Matrix-free 7-point operator on a (1,1,1)-haloed 3D field."""
    return (6.0 * h.interior
            - h.shift((-1, 0, 0)) - h.shift((1, 0, 0))
            - h.shift((0, -1, 0)) - h.shift((0, 1, 0))
            - h.shift((0, 0, -1)) - h.shift((0, 0, 1)))


def box_sum_1d(a, radius: int, axis: int, *, device="cuda") -> torch.Tensor:
    """Sliding-window sum of width 2r+1 along `axis`, zero halo."""
    a = as_tensor(a, device)
    lo = [0] * a.ndim
    hi = [0] * a.ndim
    lo[axis] = radius + 1
    hi[axis] = radius
    return box_sum_halo(HaloArray.wrap(a, tuple(lo), tuple(hi)), radius,
                        axis)


def blur_x(a, radius: int = 8, *, device="cuda") -> torch.Tensor:
    """The reference's BM_*_blur_x: sum over a(y, x±r)."""
    return box_sum_1d(a, radius, axis=1, device=device)


def blur_y(a, radius: int = 8, *, device="cuda") -> torch.Tensor:
    return box_sum_1d(a, radius, axis=0, device=device)


def blur2d(a, radius: int = 8, *, device="cuda") -> torch.Tensor:
    """Separable 2D box sum (X then Y)."""
    return blur_y(blur_x(a, radius, device=device), radius)


def _stencil_input(u, device) -> torch.Tensor:
    """u on `device`; bool as float32, the dtype the reference's float
    coefficients promote it to (torch refuses to subtract bools)."""
    u = as_tensor(u, device)
    return u.to(torch.float32) if u.dtype == torch.bool else u


def poisson5_apply(u, *, device="cuda") -> torch.Tensor:
    """4u - u_N - u_S - u_E - u_W, zero Dirichlet halo."""
    return poisson5_halo(HaloArray.wrap(_stencil_input(u, device), 1))


def poisson7_apply(u, *, device="cuda") -> torch.Tensor:
    """6u - the 6 face neighbours, zero Dirichlet halo."""
    return poisson7_halo(HaloArray.wrap(_stencil_input(u, device), 1))


# ---------------------------------------------------------------------------
# K19: the explicit-halo 2-D box sum
# ---------------------------------------------------------------------------


def blur2d_pallas_torch(a: torch.Tensor, radius: int = 8) -> torch.Tensor:
    """Plain version of K19, adding in the kernel's order: along x, the
    2r + 1 terms from left to right; then along y, from top to bottom
    (halo cells are zero)."""
    r = radius
    m, n = a.shape
    ap = torch.nn.functional.pad(a, (r, r, r, r))
    bx = torch.zeros((m + 2 * r, n), dtype=a.dtype, device=a.device)
    for d in range(2 * r + 1):
        bx += ap[:, d:d + n]
    out = torch.zeros((m, n), dtype=a.dtype, device=a.device)
    for d in range(2 * r + 1):
        out += bx[d:d + m]
    return out


# rows a block of csrc/blur2d.cu walks down: each band sums its 2r rows of
# top halo again, so wide radii take long bands (on an H100 at 8192^2, 256
# rows were fastest at r = 8 and 1024 at r = 16, 32 and 64: PERF.md §6)
BAND_ROWS = 256
BAND_ROWS_WIDE = 1024    # r > 8
MODES = {"tma": 0, "plain": 1}


@dataclass(frozen=True)
class BlurPlan:
    """How K19 runs on an (m, n) input of radius r: the load mode ("tma"
    or "plain") and the rows a block walks down. The kernel sizes its
    stage boxes and shared memory from r itself."""

    mode: str
    band_rows: int


def blur_plan(m: int, n: int, radius: int, data_ptr: int) -> BlurPlan:
    """K19's plan. TMA needs a 16-byte-aligned input whose rows are a
    multiple of 16 bytes (n % 4 == 0), and a box's row coordinate (< m + r)
    that fits an int32; any other input takes the plain-load mode. Radii
    past 8 take bands of BAND_ROWS_WIDE rows."""
    tma = (n % 4 == 0 and data_ptr % 16 == 0
           and m <= 2 ** 31 - 1 - MAX_KERNEL_RADIUS)
    band = BAND_ROWS if radius <= 8 else BAND_ROWS_WIDE
    return BlurPlan("tma" if tma else "plain", band)


def blur2d_pallas(a, radius: int = 8, tile_m: int | None = None, *,
                  device="cuda") -> torch.Tensor:
    """K19: 2-D box sum of radius r with a zero halo, float32. ``tile_m``
    is the reference's VMEM row tile and sets nothing here."""
    global BLUR_LAUNCHES, BLUR_TMA_LAUNCHES, BLUR_PLAIN_LAUNCHES
    a = as_tensor(a, device)
    if a.ndim != 2:
        raise ValueError(f"blur2d_pallas: 2-D input, got shape "
                         f"{tuple(a.shape)}")
    if radius < 0:
        raise ValueError(f"blur2d_pallas: radius {radius} < 0")
    dev = kernel_device(a)
    if dev.type == "cpu":
        return blur2d_pallas_torch(a, radius)
    a = a.contiguous()
    m, n = a.shape
    check_tensor(a, "a", dev, (torch.float32,), (m, n))
    if radius > MAX_KERNEL_RADIUS:
        raise ValueError(f"blur2d_pallas: radius {radius}; the kernel's "
                         f"window holds radii up to {MAX_KERNEL_RADIUS}")
    if m >= 1 << 31 or n >= 1 << 31:
        raise ValueError(f"blur2d_pallas: shape {(m, n)}; the kernel takes "
                         "dimensions < 2^31")
    plan = blur_plan(m, n, radius, a.data_ptr())
    out = torch.empty_like(a)
    if m == 0 or n == 0:
        return out
    fn = kernel_fn("blur2d_f32", 2, 5)
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), out.data_ptr(), m, n, radius, MODES[plan.mode],
                plan.band_rows, current_stream_ptr())
    check_launch(rc, "blur2d_f32")
    BLUR_LAUNCHES += 1
    if plan.mode == "tma":
        BLUR_TMA_LAUNCHES += 1
    else:
        BLUR_PLAIN_LAUNCHES += 1
    return out
