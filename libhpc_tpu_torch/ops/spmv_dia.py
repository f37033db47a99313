"""Streaming DIA SpMV — the structured path for large banded matrices.

Port of ``libhpc_tpu/ops/dia_pallas.py`` (``DiaPallas``,
``dia_spmv_pallas``, ``dia_pattern_probe``):

  ``dia_out`` wraps the hand-written CUDA kernel ``csrc/dia.cu:dia_spmv_f32``
    (K4, the port of ``dia_pallas.py:_kernel``); ``dia_out_torch`` is its
    plain PyTorch version.
  ``dia_probe_out`` wraps ``csrc/dia.cu:dia_probe_f32`` (K5, the port of
    ``dia_pallas.py:_probe_kernel``), the kernel's access pattern with plane
    adds only, whose time is the denominator of the DIA fraction;
    ``dia_probe_out_torch`` is its plain version.

Both read the extended x (``x_ext``: x with ``x_pad_lo`` zeros in front and
zeros behind, flat) and write (n_tiles * T/128, 128) f32:

  kernel  out[g T + i] = sum_d plane[g, d, i] * x_ext[g T + i + coffs[d]]
  probe   out[g T + i] = x_ext[g T + i] + x_ext[g T + span_pad + i]
                         + sum_d plane[g, d, i]

The wrappers run the plain version for CPU tensors only; for CUDA tensors
they launch the kernel or raise. ``DIA_LAUNCHES`` and ``PROBE_LAUNCHES``
count kernel launches. While a profiler records, ``dia_spmv_pallas``'s
``extend_x`` is a ``libhpc.spmv.prepare`` range and ``dia_out`` a
``libhpc.spmv.launch`` range (``utils/profiling.annotate``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from libhpc_tpu_torch.ops._cuda_utils import (check_launch, check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)
from libhpc_tpu_torch.ops.spmv import MAX_DIA_OFFSETS
from libhpc_tpu_torch.sparse._leaves import TensorLeaves, tensor_to_numpy
from libhpc_tpu_torch.utils.profiling import (SPMV_LAUNCH, SPMV_PREPARE,
                                              annotate)

LANE = 128

DIA_LAUNCHES = 0
PROBE_LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class DiaPallas(TensorLeaves):
    """Tiled DIA operand for the streaming kernel."""

    dflat: torch.Tensor  # (n_tiles * D * T/128, 128) per-tile diag planes
    x_pad_lo: int = dataclasses.field(metadata=dict(static=True))
    coffs: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    T: int = dataclasses.field(metadata=dict(static=True))
    span_pad: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_tiles(self) -> int:
        D = len(self.coffs)
        return self.dflat.shape[0] // (D * (self.T // LANE))

    @property
    def hbm_bytes(self) -> int:
        """Per-SpMV traffic: diagonal planes + x + y (+ the per-tile x
        window overlap, which is span_pad per tile)."""
        m, n = self.shape
        return (self.dflat.numel() * 4 + n * 4 + m * 4
                + self.n_tiles * self.span_pad * 4)

    @staticmethod
    def from_dia(dia, T: int = 1 << 17, device="cuda") -> "DiaPallas":
        """Host-side tiling of a DIA container (sparse/dia.py) on any
        device; the leaves move to ``device`` once at the end."""
        data = tensor_to_numpy(dia.data).astype(np.float32)
        offs = [int(o) for o in dia.offsets]
        m, n = dia.shape
        D = len(offs)
        o_min, o_max = min(offs + [0]), max(offs + [0])
        P = ((-o_min + 1023) // 1024) * 1024      # aligned left x pad
        span = o_max + P
        span_pad = ((span + 1024) // 1024) * 1024
        n_tiles = -(-m // T)
        m_pad = n_tiles * T
        Tr = T // LANE
        dflat = np.zeros((n_tiles, D, Tr, LANE), np.float32)
        for d, o in enumerate(offs):
            # y[i] = sum_d data[d, i+o] * x[i+o]; valid j=i+o range:
            j0, j1 = max(0, o), min(n, m + o)
            if j1 <= j0:
                continue
            # plane[d][i] = data[d, i+o] for i in [j0-o, j1-o)
            plane = np.zeros(m_pad, np.float32)
            plane[j0 - o:j1 - o] = data[d, j0:j1]
            dflat[:, d] = plane.reshape(n_tiles, Tr, LANE)
        coffs = tuple(P + o for o in offs)        # in-window offsets >= 0
        return DiaPallas(
            dflat=torch.from_numpy(dflat.reshape(n_tiles * D * Tr, LANE)),
            x_pad_lo=P, coffs=coffs, shape=(m, n), T=T,
            span_pad=span_pad).to(device)


def x_ext_len(dp: DiaPallas) -> int:
    """Length of the extended x: window coverage needs P + n_tiles*T +
    span_pad; a WIDE rectangular matrix (ncols beyond the diagonals' reach)
    needs room for all of x too — the larger, rounded up to whole rows."""
    n = dp.shape[1]
    return max(dp.x_pad_lo + dp.n_tiles * dp.T + dp.span_pad,
               -(-(dp.x_pad_lo + n) // LANE) * LANE)


def extend_x(dp: DiaPallas, x: torch.Tensor) -> torch.Tensor:
    """x (ncols,) f32 -> x_ext (x_ext_len(dp),): x_pad_lo zeros, x, zeros."""
    n = dp.shape[1]
    return torch.nn.functional.pad(
        x, (dp.x_pad_lo, x_ext_len(dp) - dp.x_pad_lo - n))


def dia_out_torch(dp: DiaPallas, x_ext: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: per-tile offset gathers, which are slices of
    x_ext because the tiles are consecutive rows."""
    nt, T = dp.n_tiles, dp.T
    planes = dp.dflat.reshape(nt, len(dp.coffs), T)
    acc = torch.zeros((nt, T), dtype=torch.float32, device=x_ext.device)
    for d, c in enumerate(dp.coffs):
        acc = acc + planes[:, d] * x_ext[c:c + nt * T].reshape(nt, T)
    return acc.reshape(nt * T // LANE, LANE)


def dia_probe_out_torch(dp: DiaPallas, x_ext: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: the two window reads plus every plane."""
    nt, T, sp = dp.n_tiles, dp.T, dp.span_pad
    planes = dp.dflat.reshape(nt, len(dp.coffs), T)
    acc = (x_ext[:nt * T].reshape(nt, T)
           + x_ext[sp:sp + nt * T].reshape(nt, T))
    for d in range(len(dp.coffs)):
        acc = acc + planes[:, d]
    return acc.reshape(nt * T // LANE, LANE)


def _launch(name: str, dp: DiaPallas, x_ext: torch.Tensor,
            dev: torch.device) -> torch.Tensor:
    """Check the operands and launch csrc/dia.cu's entry point `name`."""
    nt, T, D = dp.n_tiles, dp.T, len(dp.coffs)
    if not 0 < D <= MAX_DIA_OFFSETS:      # csrc/dia.cu's kMaxD
        raise ValueError(f"{D} diagonals outside 1..{MAX_DIA_OFFSETS}")
    if T % LANE:
        raise ValueError(f"T={T} is not a multiple of {LANE}")
    check_tensor(dp.dflat, "dflat", dev, (torch.float32,),
                 (nt * D * (T // LANE), LANE))
    check_tensor(x_ext, "x_ext", dev, (torch.float32,), (x_ext_len(dp),))
    if dp.dflat.data_ptr() % 16:
        raise ValueError("dflat is not 16-byte aligned")
    out = torch.empty((nt * T // LANE, LANE), dtype=torch.float32,
                      device=dev)
    coffs = (ctypes.c_int * D)(*dp.coffs)
    fn = kernel_fn(name, 4, 4)
    with torch.cuda.device(dev):
        rc = fn(dp.dflat.data_ptr(), x_ext.data_ptr(),
                ctypes.addressof(coffs), out.data_ptr(), nt, D, T,
                dp.span_pad, current_stream_ptr())
    check_launch(rc, name)
    return out


def dia_out(dp: DiaPallas, x_ext: torch.Tensor) -> torch.Tensor:
    """K4: (n_tiles * T/128, 128) f32 rows of y (padded to whole tiles)."""
    global DIA_LAUNCHES
    with annotate(SPMV_LAUNCH):
        dev = kernel_device(dp.dflat, x_ext)
        if dev.type == "cpu":
            return dia_out_torch(dp, x_ext)
        out = _launch("dia_spmv_f32", dp, x_ext, dev)
    DIA_LAUNCHES += 1
    return out


def dia_probe_out(dp: DiaPallas, x_ext: torch.Tensor) -> torch.Tensor:
    """K5: the pattern-matched probe over x_ext, (n_tiles * T/128, 128)."""
    global PROBE_LAUNCHES
    dev = kernel_device(dp.dflat, x_ext)
    if dev.type == "cpu":
        return dia_probe_out_torch(dp, x_ext)
    out = _launch("dia_probe_f32", dp, x_ext, dev)
    PROBE_LAUNCHES += 1
    return out


def dia_pattern_probe(dp: DiaPallas, x: torch.Tensor) -> torch.Tensor:
    """Run the pattern-matched probe over dp's exact operands. Returns a
    (n_tiles*T/128, 128) tensor; time it as dia_spmv_pallas is timed —
    fraction = t_probe / t_kernel, and dp.hbm_bytes / t_probe is the
    access pattern's speed of light in GB/s."""
    return dia_probe_out(dp, extend_x(dp, x))


def dia_spmv_pallas(dp: DiaPallas, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a DiaPallas operand; x f32 (ncols,) -> f32 (nrows,)."""
    with annotate(SPMV_PREPARE):
        x_ext = extend_x(dp, x)
    return dia_out(dp, x_ext).reshape(-1)[:dp.shape[0]]
