"""Checkpoint / resume for long solver runs (SURVEY.md §5.4: absent in
libHPC; here for long CG / multigrid loops).

Port of ``libhpc_tpu/utils/checkpoint.py`` with the reference's ``.npz``
layout: one array ``leaf_{i}`` a leaf, in the order JAX flattens the same
structure, and ``__treedef__``, the structure as text (informative; both
packages restore into the structure of ``like``). A checkpoint written by
either package restores in the other, leaf for leaf.

State is any nesting of dicts (leaves in sorted key order, as JAX's),
tuples and lists (in order), None (no leaf), the port's containers (their
tensor fields in field order; static and derived fields are not leaves)
and leaves: tensors, numpy arrays and Python scalars. ``restore(path,
like)`` puts every leaf on the device and in the dtype of ``like``'s
matching leaf; a leaf that is not a tensor in ``like`` comes back as a
CPU tensor of the saved dtype. bfloat16 leaves are saved as their int16
bit patterns.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from libhpc_tpu_torch.sparse._leaves import (TensorLeaves, _is_derived,
                                             _is_static, tensor_to_numpy)


def _flatten(state, leaves: list) -> str:
    """Append state's leaves to `leaves` in JAX's order; return the
    structure as text ('*' a leaf)."""
    if isinstance(state, dict):
        parts = [f"{k!r}: {_flatten(state[k], leaves)}"
                 for k in sorted(state)]
        return "{" + ", ".join(parts) + "}"
    if isinstance(state, (tuple, list)):
        parts = [_flatten(v, leaves) for v in state]
        if isinstance(state, list):
            return "[" + ", ".join(parts) + "]"
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    if state is None:
        return "None"
    if isinstance(state, TensorLeaves):
        parts = [_flatten(getattr(state, f.name), leaves)
                 for f in dataclasses.fields(state)
                 if not (_is_static(f) or _is_derived(f))]
        return f"{type(state).__name__}(" + ", ".join(parts) + ")"
    leaves.append(state)
    return "*"


def _unflatten(like, it):
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, it) for v in like)
    if like is None:
        return None
    if isinstance(like, TensorLeaves):
        # derived fields go back to None: the container builds them again
        # from the restored leaves
        new = {f.name: (None if _is_derived(f)
                        else _unflatten(getattr(like, f.name), it))
               for f in dataclasses.fields(like) if not _is_static(f)}
        return dataclasses.replace(like, **new)
    return _leaf_like(next(it), like)


def _leaf_like(arr: np.ndarray, like):
    if not isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr))
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype != np.float16:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return tensor_to_numpy(leaf)
    return np.asarray(leaf)


def save(path: str, state) -> None:
    leaves: list = []
    treedef = _flatten(state, leaves)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(
        path,
        __treedef__=np.frombuffer(treedef.encode(), dtype=np.uint8),
        **{f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)},
    )


def restore(path: str, like):
    """Restore into the structure of `like` (the template), each leaf on
    the device and in the dtype of `like`'s."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves_like: list = []
    _flatten(like, leaves_like)
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(leaves_like))]
    return _unflatten(like, iter(leaves))
