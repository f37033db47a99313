"""Exclusive / inclusive scans — the middle stage of the count -> scan ->
scatter radix sort.

Port of ``libhpc_tpu/ops/scan.py``, the descendant of libHPC's hierarchical
1024-fan-in exclusive scan
(lib/gpu/radix_gpu/include/cuda_hierarchical_exclusive_scan_localT_1024.cuh):

  exclusive_scan(x), inclusive_scan(x)
                 plain torch along the last axis, as the reference's are
                 plain XLA; the result keeps x's dtype (integer sums wrap,
                 as ``jnp.cumsum`` without 64-bit types does; ``torch.cumsum``
                 would widen int32 to int64 unless given ``dtype=``)
  exclusive_scan_pallas(x)
                 1-D; float32 goes to K13 (``_exclusive_scan_f32``, the port
                 of ``_exclusive_scan_mxu``), integers of at most 32 bits to
                 K14 (``_exclusive_scan_int``, the port of
                 ``_scan_tile_kernel``): both in ``csrc/scan.cu``, one
                 pass with a decoupled look-back over tiles of 8192
                 elements (x read once, out written once)

Integer dtypes: the reference keeps every integer dtype and wraps in it
(int8 to uint32 alike, checked on the CPU). The port does the same: K14 adds
32-bit integers, and narrower ones are widened to int32, scanned and
narrowed back, which wraps them the same way. 64-bit integers have no
counterpart in the reference (its arrays are 32-bit), so
``exclusive_scan_pallas`` refuses them; ``exclusive_scan`` keeps int64.

The reference's float32 kernel reached exact-to-rounding sums through a
triangular matmul at ``Precision.HIGHEST``; K13 adds in FP32 on the CUDA
cores, in another order, so it agrees with the reference to rounding
(rtol 1e-4 against a float64 oracle, as tests/test_scan_reduce.py holds
the reference); where each tile's look-back stops sets how the tiles' sums
associate, so its last bits may differ from run to run. K14 is exact.
``tile_cumsum`` and the (512,128) / (8,512) blockings are TPU mechanics
and not ported; ``SUBLANES``, ``WIDE``, ``TILE`` and ``MXU_ROWS`` keep the
reference's values.

Dispatch: CPU tensors take the plain versions (``*_torch``); CUDA tensors
launch the kernels or raise. A numpy input is moved to ``device`` (default
``"cuda"``). ``SCAN_F32_LAUNCHES`` and ``SCAN_INT_LAUNCHES`` count the
kernel calls of K13 and K14 (one a call, one kernel launch each).
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.ops._cuda_utils import (as_tensor, cdiv,
                                              check_launch, check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)

SUBLANES = 8
WIDE = 512              # lanes per row of the reference's integer kernel
TILE = SUBLANES * WIDE  # elements per grid step of the reference's kernel
MXU_ROWS = 512          # rows per grid step of the reference's f32 kernel

BLOCK = 8192            # elements per tile of csrc/scan.cu

SCAN_F32_LAUNCHES = 0
SCAN_INT_LAUNCHES = 0

# torch's unsigned 16- to 64-bit dtypes do not add: scan their signed view
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}
_NARROW_INTS = (torch.int8, torch.uint8, torch.int16, torch.uint16)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along the last axis in x's own dtype (bool counts in
    int32, as jnp.cumsum promotes it)."""
    if x.dtype in _SIGNED:
        return _cumsum(x.view(_SIGNED[x.dtype])).view(x.dtype)
    if x.dtype == torch.bool:
        return torch.cumsum(x, dim=-1, dtype=torch.int32)
    return torch.cumsum(x, dim=-1, dtype=x.dtype)


def inclusive_scan(x, *, device="cuda") -> torch.Tensor:
    return _cumsum(as_tensor(x, device))


def exclusive_scan(x, *, device="cuda") -> torch.Tensor:
    """Exclusive prefix sum along the last axis (plain torch path)."""
    x = as_tensor(x, device)
    if x.dtype in _SIGNED:
        return exclusive_scan(x.view(_SIGNED[x.dtype])).view(x.dtype)
    c = _cumsum(x)
    return c - x.to(c.dtype)


def scan_scratch_len(n: int) -> int:
    """64-bit words of the kernel's scratch (scan.cu): the tile counter,
    then one status word a tile."""
    return 1 + cdiv(n, BLOCK)


def _exclusive_scan_f32_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K13: out[0] = 0, out[1:] = cumsum(x[:-1])."""
    out = torch.zeros_like(x)
    out[1:] = torch.cumsum(x[:-1], dim=0)
    return out


def _exclusive_scan_int_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K14 on int32: sums in int64, wrapped to int32."""
    out = torch.zeros_like(x)
    out[1:] = torch.cumsum(x[:-1], dim=0, dtype=torch.int64).to(torch.int32)
    return out


def _launch(x: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    dev = kernel_device(x)
    n = x.shape[0] if x.ndim == 1 else -1
    check_tensor(x, "x", dev, (dtype,), (n,))
    if n >= 1 << 31:
        raise ValueError(f"{name}: {n} elements; the kernel takes < 2^31")
    out = torch.empty_like(x)
    if n == 0:
        return out
    # the status words start at "nothing published", the counter at 0
    scratch = torch.zeros(scan_scratch_len(n), dtype=torch.int64, device=dev)
    fn = kernel_fn(name, 3, 1)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
                current_stream_ptr())
    check_launch(rc, name)
    return out


def _exclusive_scan_f32(x: torch.Tensor) -> torch.Tensor:
    """K13: exclusive scan of a 1-D float32 tensor."""
    global SCAN_F32_LAUNCHES
    if kernel_device(x).type == "cpu":
        return _exclusive_scan_f32_torch(x)
    out = _launch(x, torch.float32, "scan_exclusive_f32")
    SCAN_F32_LAUNCHES += 1
    return out


def _exclusive_scan_int(x: torch.Tensor) -> torch.Tensor:
    """K14: exclusive scan of a 1-D int32 tensor, wrapping like int32."""
    global SCAN_INT_LAUNCHES
    if kernel_device(x).type == "cpu":
        return _exclusive_scan_int_torch(x)
    out = _launch(x, torch.int32, "scan_exclusive_i32")
    SCAN_INT_LAUNCHES += 1
    return out


def exclusive_scan_pallas(x, *, device="cuda") -> torch.Tensor:
    """Exclusive scan of a 1-D array through the kernels: float32 by K13,
    integers of at most 32 bits by K14 (exact, wrapping in x's dtype).
    Other dtypes raise TypeError on every device."""
    x = as_tensor(x, device)
    if x.ndim != 1:
        raise ValueError(f"exclusive_scan_pallas: 1-D input, got shape "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    if x.dtype == torch.float32:
        return _exclusive_scan_f32(x)
    if x.dtype in (torch.int32, torch.uint32):
        return _exclusive_scan_int(x.view(torch.int32)).view(x.dtype)
    if x.dtype in _NARROW_INTS:
        v = x.view(_SIGNED.get(x.dtype, x.dtype))
        out = _exclusive_scan_int(v.to(torch.int32)).to(v.dtype)
        return out.view(x.dtype)
    raise TypeError(f"exclusive_scan_pallas: dtype {x.dtype}; the kernels "
                    "take float32 and integers of at most 32 bits")
