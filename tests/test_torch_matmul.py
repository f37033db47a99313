"""The port's tiled matmul (libhpc_tpu_torch/ops/matmul.py) against
libhpc_tpu/ops/matmul.py (CPU; the reference's Pallas kernel in interpret
mode, the port's plain version). Shapes and tolerance are
tests/test_histogram_transpose.py's: rtol 1e-4, atol 1e-3 (float32 sums in
another order), at its tiles of 128.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhpc_tpu.ops.matmul import matmul_pallas as ref_matmul
from libhpc_tpu_torch.ops import matmul as mm

TOL = dict(rtol=1e-4, atol=1e-3)
TILES = dict(tile_m=128, tile_n=128, tile_k=128)


@pytest.mark.parametrize("shape", [((8, 8), (8, 8)), ((100, 200), (200, 50)),
                                   ((256, 512), (512, 256)),
                                   ((300, 300), (300, 300))])
def test_matmul_pallas(rng, shape):
    (am, ak), (bk, bn) = shape
    a = rng.random((am, ak)).astype(np.float32)
    b = rng.random((bk, bn)).astype(np.float32)
    got = mm.matmul_pallas(a, b, device="cpu", **TILES)
    assert got.dtype == torch.float32 and got.shape == (am, bn)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)
    want = np.asarray(ref_matmul(jnp.asarray(a), jnp.asarray(b), **TILES))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_matmul_pallas_bf16(rng):
    """bfloat16 operands: float32 accumulation, a bfloat16 result equal to
    the reference's to one bfloat16 rounding."""
    a = rng.random((96, 160)).astype(np.float32)
    b = rng.random((160, 72)).astype(np.float32)
    ab = jnp.asarray(a, jnp.bfloat16)
    bb = jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(ref_matmul(ab, bb, **TILES).astype(jnp.float32))
    ta = torch.from_numpy(np.array(ab.astype(jnp.float32))).bfloat16()
    tb = torch.from_numpy(np.array(bb.astype(jnp.float32))).bfloat16()
    got = mm.matmul_pallas(ta, tb, **TILES)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3, atol=0)
    exact = ta.double() @ tb.double()
    np.testing.assert_allclose(got.float().numpy(), exact.numpy(), rtol=8e-3)


@pytest.mark.parametrize("tiles", [dict(tile_m=8, tile_n=8, tile_k=8),
                                   dict(tile_m=256, tile_n=256, tile_k=512),
                                   dict(tile_k=7)])
def test_tiles_set_nothing(rng, tiles):
    """The tile_* arguments set the reference's padding only: any value
    gives the product."""
    a = rng.random((40, 33)).astype(np.float32)
    b = rng.random((33, 21)).astype(np.float32)
    got = mm.matmul_pallas(torch.from_numpy(a), torch.from_numpy(b), **tiles)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)


def test_shapes_must_chain():
    with pytest.raises(ValueError):
        mm.matmul_pallas(torch.zeros(4, 5), torch.zeros(4, 5))


def test_kernel_wrapper_on_cpu_is_the_plain_version(rng, monkeypatch):
    monkeypatch.setattr(mm, "MATMUL_LAUNCHES", 0)
    a = torch.from_numpy(rng.random((70, 1100)).astype(np.float32))
    b = torch.from_numpy(rng.random((1100, 30)).astype(np.float32))
    assert torch.equal(mm.matmul_pallas(a, b),
                       mm.matmul_pallas_torch(a, b, 512))
    assert mm.MATMUL_LAUNCHES == 0
