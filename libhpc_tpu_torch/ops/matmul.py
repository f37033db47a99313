"""Tiled dense matmul: the reference's blocked-matmul workload
(tests/test_hpc_benchmark/test_hpc_benchmark.cpp:758-784, 1024^2).

Port of ``libhpc_tpu/ops/matmul.py``:

  matmul_pallas(a, b, tile_m=256, tile_n=256, tile_k=512)
                 C = A @ B with a float32 accumulator, returned in
                 ``a.dtype``, through the hand-written CUDA kernels of
                 ``csrc/matmul.cu`` (K18, the port of
                 ``matmul.py:_mm_kernel``); ``matmul_pallas_torch`` is its
                 plain version: the reference's K loop over ``tile_k``-deep
                 slices, each product added into a float32 accumulator

The ``tile_*`` arguments keep the reference's signature. There they set the
padding and the VMEM blocks; they never change the result. The plain
version walks K in ``tile_k`` steps as the reference's grid does; the
kernels have their own fixed tiling (128 x 128 outputs a block).

bfloat16 and float16 run on the tensor cores: ``wgmma`` fed by a ring of
TMA loads in shared memory, bound by the 2MNK operations at the tensor
cores' 989 TFLOP/s. The kernel reads both operands K-major, so B goes
through K17 (``transpose_pallas``) first, and K is padded with zeros to a
multiple of 8 where TMA needs it (``tma_operands``). float32 runs on FP32
fused multiply-adds on the CUDA cores (67 TFLOP/s), never TF32 (10
mantissa bits would miss the reference's tolerance). Dispatch: CPU tensors
take the plain version; CUDA tensors launch the kernel or raise. A numpy
input goes to ``device`` (default ``"cuda"``). ``MATMUL_LAUNCHES`` counts
K18 launches; a half-width call also adds one to
``transpose.TRANSPOSE_LAUNCHES``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from libhpc_tpu_torch.ops._cuda_utils import (as_tensor, check_launch,
                                              check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn,
                                              round_up)
from libhpc_tpu_torch.ops.transpose import transpose_pallas

MATMUL_LAUNCHES = 0

_MATMUL_FN = {torch.float32: "matmul_f32", torch.bfloat16: "matmul_bf16",
              torch.float16: "matmul_f16"}


def matmul_pallas_torch(a: torch.Tensor, b: torch.Tensor,
                        tile_k: int = 512) -> torch.Tensor:
    """Plain version of K18: acc (float32) += A[:, k:k+tile_k] @
    B[k:k+tile_k, :] over k, then acc in a.dtype."""
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, tile_k):
        acc += a[:, k0:k0 + tile_k].float() @ b[k0:k0 + tile_k].float()
    return acc.to(a.dtype)


def tma_operands(a: torch.Tensor, b: torch.Tensor):
    """The tensor-core kernel's operands for A (M, K) @ B (K, N): A and
    B^T (N, K), both contiguous with K a multiple of 8 (TMA's 16-byte row
    stride) and 16-byte-aligned starts. Where K is ragged both are padded
    with zeros, as the reference pads; M and N are not padded (TMA
    zero-fills past them). B^T is K17's, one launch on the card."""
    k = a.shape[1]
    kp = round_up(k, 8)
    if kp != k:
        a = F.pad(a, (0, kp - k))
        b = F.pad(b, (0, 0, 0, kp - k))
    elif a.data_ptr() % 16:
        a = a.clone()  # a view at an odd offset: a fresh, aligned copy
    return a, transpose_pallas(b)


def matmul_pallas(a, b, tile_m: int = 256, tile_n: int = 256,
                  tile_k: int = 512, *, device="cuda") -> torch.Tensor:
    """K18: C = A @ B with float32 accumulation, in a.dtype."""
    global MATMUL_LAUNCHES
    a, b = as_tensor(a, device), as_tensor(b, device)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_pallas: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    dev = kernel_device(a, b)
    if dev.type == "cpu":
        return matmul_pallas_torch(a, b, tile_k)
    a, b = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    check_tensor(a, "a", dev, tuple(_MATMUL_FN), (m, k))
    check_tensor(b, "b", dev, (a.dtype,), (k, n))
    if max(m, n, k) >= 1 << 31:
        raise ValueError(f"matmul_pallas: ({m}, {k}) @ ({k}, {n}); the "
                         "kernel takes dimensions < 2^31")
    name = _MATMUL_FN[a.dtype]
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=a.dtype, device=dev)
    if a.dtype != torch.float32:
        if k == 0:  # a tensor map takes no empty dimension
            return torch.zeros((m, n), dtype=a.dtype, device=dev)
        a, b = tma_operands(a, b)  # b is now B^T (N, K padded)
        k = a.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    fn = kernel_fn(name, 3, 3)
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                current_stream_ptr())
    if rc < 0:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused the "
                           f"operands' tensor map (CUresult {-rc})")
    check_launch(rc, name)
    MATMUL_LAUNCHES += 1
    return out
