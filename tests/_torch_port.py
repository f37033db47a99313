"""Helpers shared by the PyTorch-port tests (tests/test_torch_*.py).

This module imports no JAX: the GPU tests, which run where JAX is not
installed, use it too. Reference containers are read through their
dataclass fields only.
"""

import dataclasses

import numpy as np
import pytest
import torch


def _port_class(name):
    from libhpc_tpu_torch import containers
    from libhpc_tpu_torch.ops import sellp, spmv_dia, spmv_sell
    from libhpc_tpu_torch.sparse import csr, dia, ell, grid, sbell

    return {"CSR": csr.CSR, "SBELL": sbell.SBELL, "FarPane": sbell.FarPane,
            "FarBlocks": sbell.FarBlocks, "DIA": dia.DIA, "ELL": ell.ELL,
            "DiaPallas": spmv_dia.DiaPallas, "SELL": spmv_sell.SELL,
            "SELLSplit": spmv_sell.SELLSplit, "SELLP": sellp.SELLP,
            "HaloArray": containers.HaloArray, "BlockGrid": grid.BlockGrid,
            "NestedGrid": grid.NestedGrid}[name]


def port_of(ref):
    """The port's container built from a reference container's leaves
    (np.asarray of each array, bf16 included) and static fields."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.metadata.get("static"):
            statics[f.name] = v
        elif v is None:
            statics[f.name] = None
        elif dataclasses.is_dataclass(v):
            statics[f.name] = port_of(v)
        else:
            arrays[f.name] = np.asarray(v)
    return _port_class(type(ref).__name__).from_numpy(arrays, **statics)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same_container(port, ref):
    """Array-by-array (bf16 bit for bit) and static-field equality of a
    port container with a reference container, far set included."""
    assert type(port).__name__ == type(ref).__name__
    leaves = port.to_numpy()
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.metadata.get("static"):
            assert getattr(port, f.name) == v, f.name
        elif v is None:
            assert getattr(port, f.name) is None, f.name
        elif dataclasses.is_dataclass(v):
            assert_same_container(getattr(port, f.name), v)
        else:
            want = _bits(v)
            got = leaves[f.name]
            assert got.dtype == want.dtype, (f.name, got.dtype, want.dtype)
            assert got.shape == want.shape, (f.name, got.shape, want.shape)
            assert np.array_equal(got, want), f.name


@pytest.fixture
def cuda_device():
    """The CUDA device, with TF32 off so plain versions run in full f32;
    skips the test where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# the chunk sorts' key sets (K8, K11): ties, the extremes of the u32 and
# int32 orders, runs, and keys that differ in one digit of each pass
CHUNK_KEY_KINDS = ("all_equal", "zero_and_max", "sign_neighbours",
                   "alphabet3", "sorted", "reversed", "one_digit", "random")


def chunk_keys(kind, n, bits=8, seed=0):
    """n uint32 keys of `kind` (CHUNK_KEY_KINDS), from a seed. one_digit:
    a base key whose digit of pass k (k = index mod the pass count of
    `bits`-bit digits) is replaced by a random one."""
    rng = np.random.default_rng(seed)
    u32 = lambda m: rng.integers(0, 2**32, size=m, dtype=np.uint32)  # noqa
    if kind == "all_equal":
        return np.full(n, 0xDEADBEEF, np.uint32)
    if kind == "zero_and_max":
        return rng.choice(np.array([0, 0xFFFFFFFF], np.uint32), n)
    if kind == "sign_neighbours":
        return rng.choice(np.array([0x7FFFFFFE, 0x7FFFFFFF, 0x80000000,
                                    0x80000001], np.uint32), n)
    if kind == "alphabet3":
        return rng.choice(u32(3), n)
    if kind == "sorted":
        return np.sort(u32(n))
    if kind == "reversed":
        return np.sort(u32(n))[::-1].copy()
    if kind == "one_digit":
        passes = -(-32 // bits)
        shift = (np.arange(n, dtype=np.uint64) % passes) * bits
        mask = np.uint64((1 << bits) - 1)
        base = np.uint64(u32(1)[0])
        digit = rng.integers(0, 1 << bits, size=n).astype(np.uint64)
        key = (base & ~(mask << shift)) | (digit << shift)
        return (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if kind == "random":
        return u32(n)
    raise ValueError(kind)
