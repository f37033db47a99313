"""Invariant checking (SURVEY.md §5.2).

Port of ``libhpc_tpu/utils/validate.py``. libHPC guards its kernels with
device traps (``asm("trap;")`` on out-of-bounds scatter positions,
cuda_radix_scatter.cuh:94,176) and a sync-and-check after every launch.
The reference offers ``checkify``-wrapped validators, host-side
``validate_*`` raising ValueError, and a ``debug_nans`` toggle; the port:

  - ``csr_invariants_checked`` reduces each check to a flag on the CSR's
    own device and returns ``(err, ())`` as ``checkify`` does; the host
    waits for the flags only at ``err.get()`` / ``err.throw()`` (one
    copy of all of them). No device assert: a failed device assert on the
    card leaves the CUDA context unusable.
  - ``validate_csr`` is host-side, as the reference's.
  - ``debug_nans`` checks the output of every torch function for NaN
    while it is on (``torch.overrides.TorchFunctionMode``): the nearest
    thing to ``jax_debug_nans`` that torch has. It does not see inside
    the hand-written CUDA kernels (ctypes launches, not torch functions)
    nor the ops that run inside one torch function, and it syncs the host
    after every op that returns a floating tensor.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.overrides import TorchFunctionMode


class CheckError:
    """The checks of one validation: (flag, message) pairs, each flag a
    0-d bool tensor on the checked container's device, True when the
    invariant holds. The first failed check, in order, is the error."""

    def __init__(self, checks):
        self._checks = list(checks)

    def get(self) -> str | None:
        """The first failed check's message, or None; one host sync."""
        if not self._checks:
            return None
        ok = torch.stack([flag for flag, _ in self._checks]).cpu().tolist()
        for passed, (_, msg) in zip(ok, self._checks):
            if not passed:
                return msg
        return None

    def throw(self) -> None:
        """Raise ValueError with the first failed check's message."""
        msg = self.get()
        if msg is not None:
            raise ValueError(msg)


def csr_invariants_checked(csr):
    """indptr monotone and bounded, indices in range, each reduced on the
    CSR's device. Returns (err, ()): err.throw() raises on a violation."""
    ip, ind = csr.indptr, csr.indices
    return CheckError([
        ((ip[1:] >= ip[:-1]).all(), "indptr not monotone"),
        (ip[0] == 0, "indptr[0] != 0"),
        (ip[-1] <= csr.nnz, "indptr[-1] > nnz"),
        (((ind >= 0) & (ind < csr.shape[1])).all(),
         "column index out of range"),
    ]), ()


def validate_csr(csr) -> None:
    """Host-side validation (raises ValueError)."""
    indptr = csr.indptr.cpu().numpy()
    indices = csr.indices.cpu().numpy()
    if indptr[0] != 0:
        raise ValueError("indptr[0] != 0")
    if (np.diff(indptr) < 0).any():
        raise ValueError("indptr not monotone")
    if indptr[-1] > len(indices):
        raise ValueError("indptr[-1] > nnz")
    if len(indices) and (indices.min() < 0 or indices.max() >= csr.shape[1]):
        raise ValueError("column index out of range")


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


class _NanCheck(TorchFunctionMode):
    """Raises FloatingPointError when a torch function returns a floating
    tensor (on the CPU or the card) holding a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if (t.device.type in ("cpu", "cuda")
                    and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                name = getattr(func, "__name__", str(func))
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {name}")
        return out


_NAN_CHECK: list = []          # the active mode, while debug_nans is on


def debug_nans(enable: bool = True) -> None:
    """Turn the NaN check on every torch function's output on or off
    (process-wide, as the reference's jax_debug_nans)."""
    if enable and not _NAN_CHECK:
        mode = _NanCheck()
        mode.__enter__()
        _NAN_CHECK.append(mode)
    elif not enable and _NAN_CHECK:
        _NAN_CHECK.pop().__exit__(None, None, None)
