"""Segmented and hierarchical reductions.

Port of ``libhpc_tpu/ops/reduce.py``, the descendant of libHPC's
hierarchical 1024-fan-in multi-pass reduce
(lib/gpu/radix_gpu/include/cuda_global_reduce_from_local.cuh:60-120):

  segment_sum / segment_max / segment_min
                       plain torch (``index_add_`` / ``scatter_reduce_``);
                       segment ids outside [0, num_segments) are dropped,
                       and an empty segment holds the reduction's identity
                       (0, the dtype's lowest or highest value), as
                       ``jax.ops.segment_*`` do
  tree_reduce_sum(x)   plain torch: the explicit multi-pass 1024-fan-in sum,
                       in x's dtype (integer sums wrap)
  row_sum_pallas(x2d)  row sums of a 2-D array through the hand-written CUDA
                       kernel ``csrc/reduce.cu`` (K16, the port of
                       ``reduce.py:_row_sum_kernel``); ``row_sum_pallas_torch``
                       is its plain version

K16 takes float32, bfloat16 and int32: floats are summed in float32 and the
sum is returned in x's dtype; int32 sums wrap, as ``jnp.sum`` in int32 does.
The reference pads x to (8k, 128k) for the TPU's tiling; the kernel reads
the rows as they are. Dispatch: CPU tensors take the plain version; CUDA
tensors launch the kernel or raise. A numpy input goes to ``device``
(default ``"cuda"``). ``ROW_SUM_LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.ops._cuda_utils import (as_tensor, cdiv, check_launch,
                                              check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)

FAN_IN = 1024  # same fan-in as the reference tree

ROW_SUM_LAUNCHES = 0

_ROW_SUM_FN = {torch.float32: "row_sum_f32", torch.bfloat16: "row_sum_bf16",
               torch.int32: "row_sum_i32"}


def _segment_ids(segment_ids, num_segments: int, device):
    """int64 ids with every id outside [0, num_segments) sent to the extra
    segment num_segments, which the caller drops."""
    ids = as_tensor(segment_ids, device).to(torch.int64)
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def segment_sum(data, segment_ids, num_segments: int, *, device="cuda"):
    data = as_tensor(data, device)
    ids = _segment_ids(segment_ids, num_segments, data.device)
    out = torch.zeros((num_segments + 1, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids, data)[:num_segments]


def _segment_reduce(data, segment_ids, num_segments, device, reduce):
    data = as_tensor(data, device)
    ids = _segment_ids(segment_ids, num_segments, data.device)
    if data.is_floating_point():
        fill = float("-inf") if reduce == "amax" else float("inf")
    else:
        info = torch.iinfo(data.dtype)
        fill = info.min if reduce == "amax" else info.max
    out = torch.full((num_segments + 1, *data.shape[1:]), fill,
                     dtype=data.dtype, device=data.device)
    idx = ids.view(-1, *([1] * (data.ndim - 1))).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce)[:num_segments]


def segment_max(data, segment_ids, num_segments: int, *, device="cuda"):
    return _segment_reduce(data, segment_ids, num_segments, device, "amax")


def segment_min(data, segment_ids, num_segments: int, *, device="cuda"):
    return _segment_reduce(data, segment_ids, num_segments, device, "amin")


def tree_reduce_sum(x, *, device="cuda") -> torch.Tensor:
    """Multi-pass 1024-fan-in sum (the reference's reduce-until-one loop):
    each pass pads to a multiple of FAN_IN and sums FAN_IN-wide groups in
    x's dtype. Returns a 0-d tensor."""
    x = as_tensor(x, device).reshape(-1)
    while x.shape[0] > 1:
        n = x.shape[0]
        xp = torch.nn.functional.pad(x, (0, cdiv(n, FAN_IN) * FAN_IN - n))
        x = xp.view(-1, FAN_IN).sum(dim=1, dtype=x.dtype)
    return x[0]


def row_sum_pallas_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K16: floats summed in float32, int32 wrapping."""
    if x.is_floating_point():
        return x.sum(dim=1, dtype=torch.float32).to(x.dtype)
    return x.sum(dim=1, dtype=x.dtype)


def row_sum_pallas(x, *, device="cuda") -> torch.Tensor:
    """K16: (M,) row sums of a 2-D (M, N) array, in x's dtype. CUDA tensors
    must be float32, bfloat16 or int32."""
    global ROW_SUM_LAUNCHES
    x = as_tensor(x, device)
    if x.ndim != 2:
        raise ValueError(f"row_sum_pallas: 2-D input, got shape "
                         f"{tuple(x.shape)}")
    dev = kernel_device(x)
    if dev.type == "cpu":
        return row_sum_pallas_torch(x)
    x = x.contiguous()
    m, n = x.shape
    check_tensor(x, "x", dev, tuple(_ROW_SUM_FN), (m, n))
    if m >= 1 << 31 or n >= 1 << 31:
        raise ValueError(f"row_sum_pallas: shape {(m, n)}; the kernel takes "
                         "dimensions < 2^31")
    out = torch.empty(m, dtype=x.dtype, device=dev)
    if m == 0:
        return out
    name = _ROW_SUM_FN[x.dtype]
    fn = kernel_fn(name, 2, 2)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), out.data_ptr(), m, n, current_stream_ptr())
    check_launch(rc, name)
    ROW_SUM_LAUNCHES += 1
    return out
