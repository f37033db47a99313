"""Dense N-D containers: HaloArray (ghost-cell array).

Port of ``libhpc_tpu/containers.py``, the re-expression of libHPC's
HPCHighDimensionFlatArray (lib/hpc/include/HPCHighDimensionFlatArray.hpp:
54-57, 107-123, 151-171): a flat N-D array with per-dimension low/high
ghost-cell widths, where negative indices address the halo. The padded
storage is one tensor; ``lo``/``hi`` are static fields, as in the
reference. The reference's two access paths map to:

  * unchecked negative-index reads -> ``shift()`` / ``window()`` views of
    the whole array (the unit a stencil consumes);
  * ``at()`` checked access -> bounds checked in Python, raising
    ``IndexError`` before any tensor is touched.

One definition of ghost cells serves both execution modes, as in the
reference: on one device ``wrap`` fills the halo with a constant (zero:
Dirichlet); distributed, ``parallel/halo.py:exchange_to_halo`` fills it
from the mesh neighbours' edge rows. The stencils of ``ops/stencil.py``
(``*_halo``) run on either.

The reference's arrays are immutable, so ``with_interior`` and ``set_halo``
return a new HaloArray over a copy of ``data``; the port does the same (a
view from ``window`` shares ``data``'s storage, as torch slicing does).
``wrap`` takes a numpy interior to ``device`` (default ``"cuda"``); a
tensor stays on its own device.
"""

from __future__ import annotations

import dataclasses

import torch

from libhpc_tpu_torch.ops._cuda_utils import as_tensor
from libhpc_tpu_torch.sparse._leaves import TensorLeaves


def _normalize(ndim: int, v) -> tuple:
    if isinstance(v, int):
        return (v,) * ndim
    v = tuple(int(x) for x in v)
    if len(v) != ndim:
        raise ValueError(f"halo spec {v} does not match ndim {ndim}")
    return v


@dataclasses.dataclass(frozen=True)
class HaloArray(TensorLeaves):
    """N-D array with per-dim (low, high) ghost cells.

    data: padded storage, shape[d] = lo[d] + interior[d] + hi[d]
    lo/hi: static per-dim halo widths
    """

    data: torch.Tensor
    lo: tuple = dataclasses.field(metadata=dict(static=True))
    hi: tuple = dataclasses.field(metadata=dict(static=True))

    # ---- construction -----------------------------------------------------

    @staticmethod
    def wrap(interior, lo, hi=None, fill=0, *, device="cuda") -> "HaloArray":
        """Surround `interior` with constant-filled ghost cells."""
        interior = as_tensor(interior, device)
        nd = interior.ndim
        lo = _normalize(nd, lo)
        hi = _normalize(nd, lo if hi is None else hi)
        pad = [w for l, h in zip(reversed(lo), reversed(hi)) for w in (l, h)]
        data = torch.nn.functional.pad(interior, pad, value=fill)
        return HaloArray(data=data, lo=lo, hi=hi)

    @staticmethod
    def from_padded(data, lo, hi=None, *, device="cuda") -> "HaloArray":
        """Adopt an already-padded array (e.g. assembled by a halo
        exchange)."""
        data = as_tensor(data, device)
        nd = data.ndim
        lo = _normalize(nd, lo)
        hi = _normalize(nd, lo if hi is None else hi)
        return HaloArray(data=data, lo=lo, hi=hi)

    # ---- geometry -----------------------------------------------------------

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def interior_shape(self) -> tuple:
        return tuple(s - l - h
                     for s, l, h in zip(self.data.shape, self.lo, self.hi))

    @property
    def interior(self) -> torch.Tensor:
        return self.window((0,) * self.ndim, self.interior_shape)

    # ---- access -------------------------------------------------------------

    def window(self, starts, shape) -> torch.Tensor:
        """Interior-relative rectangular view; negative starts address the
        halo. Bounds are checked like the reference's ``at()``."""
        starts = _normalize(self.ndim, tuple(starts))
        shape = tuple(int(s) for s in shape)
        idx = []
        for d, (s, n) in enumerate(zip(starts, shape)):
            a = self.lo[d] + s
            if a < 0 or a + n > self.data.shape[d]:
                raise IndexError(
                    f"window dim {d}: [{s}, {s + n}) exceeds halo bounds "
                    f"[-{self.lo[d]}, {self.interior_shape[d] + self.hi[d]})")
            idx.append(slice(a, a + n))
        return self.data[tuple(idx)]

    def shift(self, offsets) -> torch.Tensor:
        """Interior-shaped view displaced by `offsets` — the stencil access
        primitive: shift((-1, 0)) is the reference's a(y-1, x)."""
        return self.window(offsets, self.interior_shape)

    # ---- update -------------------------------------------------------------

    def with_interior(self, interior) -> "HaloArray":
        """Replace the interior, keeping current ghost values."""
        interior = as_tensor(interior, self.data.device)
        if tuple(interior.shape) != self.interior_shape:
            raise ValueError(
                f"interior shape {tuple(interior.shape)} != "
                f"{self.interior_shape}")
        idx = tuple(slice(l, l + n)
                    for l, n in zip(self.lo, self.interior_shape))
        data = self.data.clone()
        data[idx] = interior
        return HaloArray(data=data, lo=self.lo, hi=self.hi)

    def set_halo(self, dim: int, side: str, values) -> "HaloArray":
        """Overwrite one halo slab ('lo' or 'hi' of `dim`) — the write half
        of a halo exchange."""
        w = self.lo[dim] if side == "lo" else self.hi[dim]
        if w == 0:
            return self
        sl = [slice(None)] * self.ndim
        sl[dim] = slice(0, w) if side == "lo" \
            else slice(self.data.shape[dim] - w, self.data.shape[dim])
        data = self.data.clone()
        data[tuple(sl)] = as_tensor(values, self.data.device)
        return HaloArray(data=data, lo=self.lo, hi=self.hi)
