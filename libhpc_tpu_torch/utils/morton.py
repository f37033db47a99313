"""Morton (Z-order) codes in plain torch.

Port of ``libhpc_tpu/utils/morton.py``, the replacement for the vendored
``libmorton`` that libHPC's benchmarks call
(tests/test_hpc_benchmark/test_hpc_benchmark.cpp:705, 722). The sparse grid
uses it to give spatially adjacent tiles nearby pool slots.

The reference computes in uint32. torch's ``uint32`` is a shell dtype
(views, copies and ``.numpy()`` work; shifts and masks do not everywhere),
so the port computes in int64, masks to 32 bits, and returns the int32 bit
pattern viewed as ``torch.uint32``, as the sort modules do. Inputs may be
torch tensors of any integer dtype (taken mod 2^32), numpy arrays or Python
ints; a numpy array or an int goes to ``device`` (default ``"cuda"``), a
tensor stays on its own device.
"""

from __future__ import annotations

import numpy as np
import torch

_MASKS_2D = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)
_MASK32 = 0xFFFFFFFF


def _i64(x, device) -> torch.Tensor:
    """The u32 value of each element of x as an int64 tensor."""
    if isinstance(x, int):
        return torch.tensor(x & _MASK32, dtype=torch.int64, device=device)
    if isinstance(x, (np.ndarray, np.integer)):
        bits = np.ascontiguousarray(x).astype(np.uint32).astype(np.int64)
        return torch.from_numpy(bits).to(device)
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & _MASK32


def _u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as a torch.uint32 tensor."""
    return v.to(torch.int32).view(torch.uint32)


def _part1by1(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of x so there is a zero bit between each."""
    x = x & _MASKS_2D[0]
    x = (x | (x << 8)) & _MASKS_2D[1]
    x = (x | (x << 4)) & _MASKS_2D[2]
    x = (x | (x << 2)) & _MASKS_2D[3]
    x = (x | (x << 1)) & _MASKS_2D[4]
    return x


def _compact1by1(x: torch.Tensor) -> torch.Tensor:
    """Inverse of _part1by1: gather every other bit into the low 16 bits."""
    x = x & _MASKS_2D[4]
    x = (x | (x >> 1)) & _MASKS_2D[3]
    x = (x | (x >> 2)) & _MASKS_2D[2]
    x = (x | (x >> 4)) & _MASKS_2D[1]
    x = (x | (x >> 8)) & _MASKS_2D[0]
    return x


def morton2d_encode(x, y, *, device="cuda") -> torch.Tensor:
    """Interleave two 16-bit coordinates into one 32-bit Morton code."""
    code = _part1by1(_i64(x, device)) | (_part1by1(_i64(y, device)) << 1)
    return _u32(code)


def morton2d_decode(code, *, device="cuda"):
    """Split a 32-bit Morton code back into (x, y) coordinates."""
    c = _i64(code, device)
    return _u32(_compact1by1(c)), _u32(_compact1by1(c >> 1))


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x with two zero bits between each."""
    x = x & 0x000003FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact1by2(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def morton3d_encode(x, y, z, *, device="cuda") -> torch.Tensor:
    """Interleave three 10-bit coordinates into one 30-bit Morton code."""
    code = (_part1by2(_i64(x, device)) | (_part1by2(_i64(y, device)) << 1)
            | (_part1by2(_i64(z, device)) << 2))
    return _u32(code)


def morton3d_decode(code, *, device="cuda"):
    c = _i64(code, device)
    return (_u32(_compact1by2(c)), _u32(_compact1by2(c >> 1)),
            _u32(_compact1by2(c >> 2)))
