"""Tensor-leaf plumbing shared by the port's frozen-dataclass containers.

The reference containers are JAX pytrees: array leaves plus static fields
marked ``metadata=dict(static=True)``. The port keeps the same split. This
mixin gives every container the three operations the pytree machinery gave
the reference for free:

- ``to(device)``   moves every tensor leaf (nested containers, and tuples
                   of them, included);
- ``from_numpy``   builds the container from the reference's leaves as numpy
                   arrays (``np.asarray(leaf)``), so both packages compute on
                   identical data;
- ``to_numpy``     its inverse, for array-by-array comparison.

numpy has no native bfloat16: ``from_numpy`` takes bf16 leaves in the dtype
named ``bfloat16`` that JAX hands out, and ``to_numpy`` returns them as their
int16 bit patterns (bit-exact, comparable with ``ref.view(np.int16)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def tensor_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _is_static(f: dataclasses.Field) -> bool:
    return bool(f.metadata.get("static"))


def _is_derived(f: dataclasses.Field) -> bool:
    return bool(f.metadata.get("derived"))


class TensorLeaves:
    """Mixin for frozen dataclasses whose non-static fields are tensors,
    nested TensorLeaves containers, or None. Fields marked
    ``metadata=dict(derived=True)`` are built by the container itself and
    are neither taken by ``from_numpy`` nor returned by ``to_numpy``."""

    @property
    def device(self) -> torch.device:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                return v.device
        raise ValueError(f"{type(self).__name__} holds no tensor")

    def to(self, device):
        moved = {}
        for f in dataclasses.fields(self):
            if _is_static(f):
                continue
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorLeaves)):
                moved[f.name] = v.to(device)
            elif isinstance(v, tuple):
                moved[f.name] = tuple(e.to(device) for e in v)
        return dataclasses.replace(self, **moved)

    @classmethod
    def from_numpy(cls, arrays, **statics):
        """Build from a mapping of array leaves (numpy, bf16 included) plus
        the static fields and any nested container as keywords."""
        leaves = {k: tensor_from_numpy(v) for k, v in arrays.items()}
        return cls(**leaves, **statics)

    def to_numpy(self) -> dict:
        """{leaf name: numpy array} over the tensor leaves (bf16 as int16
        bits); nested containers convert through their own to_numpy."""
        out = {}
        for f in dataclasses.fields(self):
            if _is_static(f) or _is_derived(f):
                continue
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                out[f.name] = tensor_to_numpy(v)
        return out

    def tree_to_numpy(self) -> dict:
        """to_numpy that reaches into nested containers, tuples of them and
        None fields: {field: numpy array, nested dict, tuple or None}."""
        out = {}
        for f in dataclasses.fields(self):
            if _is_static(f) or _is_derived(f):
                continue
            out[f.name] = _tree(getattr(self, f.name))
        return out

    def statics(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if _is_static(f)}


def _tree(v):
    if isinstance(v, torch.Tensor):
        return tensor_to_numpy(v)
    if isinstance(v, TensorLeaves):
        return v.tree_to_numpy()
    if isinstance(v, tuple):
        return tuple(_tree(e) for e in v)
    return v
