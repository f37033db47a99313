"""Compensated (double-float) reductions in float32.

Port of ``libhpc_tpu/ops/precision.py``. Each value is carried as an
unevaluated (hi, lo) pair of float32s by the classic error-free
transformations:

  two_sum   Knuth's branch-free exact addition error
  two_prod  Dekker/Veltkamp split product error (no FMA dependency)
  df_add    double-float addition of (hi, lo) pairs
  sum_compensated / dot_compensated / norm2_compensated
            log2(n)-pass pairwise tree reductions in double-float

The reference computes these in plain ``jnp``, not Pallas, so the port
computes them with torch ops. Everything stays in float32. Eager PyTorch
runs each op as its own kernel and stores its float32 result, so no
product and sum are contracted into one FMA, which would change the error
terms: keep these functions out of ``torch.compile`` and off ``addcmul``.
A numpy input goes to ``device`` (default ``"cuda"``); a torch tensor
stays on its own device.
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.ops._cuda_utils import as_tensor

_SPLIT = float((1 << 12) + 1)  # Veltkamp splitter for f32 (24-bit): 4097


def two_sum(a, b):
    """s + e == a + b exactly (|e| <= ulp(s)/2)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly (Dekker, splitter-based)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(xh, xl, yh, yl):
    """(xh, xl) + (yh, yl) in double-float."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    hi, lo = two_sum(s, e)
    return hi, lo


def _tree_reduce_df(hi, lo):
    """Pairwise double-float tree reduction: log2(n) passes; an odd level
    takes one zero pair at its end, as the reference's does."""
    n = hi.shape[0]
    while n > 1:
        if n % 2:
            hi = torch.cat([hi, hi.new_zeros(1)])
            lo = torch.cat([lo, lo.new_zeros(1)])
            n += 1
        hi, lo = df_add(hi[0::2], lo[0::2], hi[1::2], lo[1::2])
        n //= 2
    return hi[0], lo[0]


def _flat_f32(x, device) -> torch.Tensor:
    return as_tensor(x, device).reshape(-1).to(torch.float32)


def sum_compensated(x, *, device="cuda"):
    """Sum of x with double-float accuracy; a 0-d float32 (hi + lo)."""
    x = _flat_f32(x, device)
    hi, lo = _tree_reduce_df(x, torch.zeros_like(x))
    return hi + lo


def dot_compensated(x, y, *, device="cuda"):
    """<x, y> with error-free products + double-float accumulation."""
    x = _flat_f32(x, device)
    y = _flat_f32(y, device)
    p, e = two_prod(x, y)
    hi, lo = _tree_reduce_df(p, e)
    return hi + lo


def norm2_compensated(x, *, device="cuda"):
    return torch.sqrt(dot_compensated(x, x, device=device))
