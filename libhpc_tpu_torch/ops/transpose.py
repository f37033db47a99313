"""Tiled matrix transpose.

Port of ``libhpc_tpu/ops/transpose.py``, the descendant of libHPC's
bank-conflict-free shared-memory transpose
(lib/gpu/util/include/cudaUtils.cuh:9-37 ``kernel_transpose``):

  transpose_pallas(x, tile=1024)
                 (M, N) -> (N, M) through the hand-written CUDA kernel
                 ``csrc/transpose.cu`` (K17, the port of
                 ``transpose.py:_transpose_kernel``) for every shape;
                 ``transpose_pallas_torch`` is its plain version
                 (``x.t().contiguous()``)
  transpose(x)   every CUDA tensor goes through K17; a CPU tensor becomes
                 ``x.T.contiguous()``. The reference routes only float32
                 arrays whose dimensions are multiples of ``BEST_TILE`` to
                 its kernel, a condition of the TPU's tiling; K17 masks
                 ragged edges and moves any word size, so it takes all.

K17 is libHPC's own kernel: 32 x 32 tiles in shared memory with a +1
column pad, ragged edges masked in the kernel (no padding copy). It moves
elements as words of their size, so it takes every dtype of 1, 2, 4 or 8
bytes (float32 and int32 as 32-bit words, bfloat16 as 16-bit words,
complex64 as 64-bit words) and raises ``TypeError`` for complex128.
``tile`` keeps the reference's signature: it sized the TPU's VMEM blocks
and sets nothing on the card.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the kernel
or raise. A numpy input goes to ``device`` (default ``"cuda"``).
``TRANSPOSE_LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.ops._cuda_utils import (as_tensor, check_launch,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)

TILE = 128
BEST_TILE = 1024  # the reference's winning tile (its round-3 TPU sweep)
WORD_BYTES = (1, 2, 4, 8)

TRANSPOSE_LAUNCHES = 0


def transpose_pallas_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K17."""
    return x.t().contiguous()


def transpose_pallas(x, tile: int = 1024, *, device="cuda") -> torch.Tensor:
    """K17: (M, N) -> (N, M). CUDA tensors may hold any dtype of 1, 2, 4 or
    8 bytes."""
    global TRANSPOSE_LAUNCHES
    x = as_tensor(x, device)
    if x.ndim != 2:
        raise ValueError(f"transpose_pallas: 2-D input, got shape "
                         f"{tuple(x.shape)}")
    dev = kernel_device(x)
    if dev.type == "cpu":
        return transpose_pallas_torch(x)
    if x.element_size() not in WORD_BYTES:
        raise TypeError(f"transpose_pallas: dtype {x.dtype}; the kernel "
                        f"moves words of {WORD_BYTES} bytes")
    x = x.contiguous()
    m, n = x.shape
    if m >= 1 << 31 or n >= 1 << 31:
        raise ValueError(f"transpose_pallas: shape {(m, n)}; the kernel "
                         "takes dimensions < 2^31")
    out = torch.empty((n, m), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    fn = kernel_fn("transpose_words", 2, 3)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), out.data_ptr(), m, n, x.element_size(),
                current_stream_ptr())
    check_launch(rc, "transpose_words")
    TRANSPOSE_LAUNCHES += 1
    return out


def transpose(x, *, device="cuda") -> torch.Tensor:
    """Matrix transpose: K17 for every CUDA tensor, ``x.T`` on the CPU."""
    x = as_tensor(x, device)
    if x.device.type == "cuda":
        return transpose_pallas(x, BEST_TILE)
    return x.T.contiguous()
