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
    from libhpc_tpu_torch.ops import sellp, spmv_dia, spmv_sell
    from libhpc_tpu_torch.sparse import csr, dia, ell, sbell

    return {"CSR": csr.CSR, "SBELL": sbell.SBELL, "FarPane": sbell.FarPane,
            "FarBlocks": sbell.FarBlocks, "DIA": dia.DIA, "ELL": ell.ELL,
            "DiaPallas": spmv_dia.DiaPallas, "SELL": spmv_sell.SELL,
            "SELLSplit": spmv_sell.SELLSplit, "SELLP": sellp.SELLP}[name]


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
