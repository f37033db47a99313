"""The port's transpose (libhpc_tpu_torch/ops/transpose.py) against
libhpc_tpu/ops/transpose.py (CPU; the reference's Pallas kernel in
interpret mode, the port's plain version). Shapes are
tests/test_histogram_transpose.py's; results must be equal exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhpc_tpu.ops import transpose as ref
from libhpc_tpu_torch.ops import transpose as tr


@pytest.mark.parametrize("shape", [(1, 1), (128, 128), (100, 300),
                                   (257, 513), (512, 128)])
def test_transpose_pallas(rng, shape):
    x = rng.random(shape).astype(np.float32)
    got = tr.transpose_pallas(x, device="cpu")
    assert got.shape == shape[::-1] and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), x.T)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.transpose_pallas(jnp.asarray(x))))


def test_transpose_int(rng):
    x = rng.integers(0, 1000, size=(130, 260)).astype(np.int32)
    got = tr.transpose_pallas(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.transpose_pallas(jnp.asarray(x))))


@pytest.mark.parametrize("tile", [128, 1024])
def test_tile_sets_nothing(rng, tile):
    """The reference's tile sized its VMEM blocks; the result is the same
    transpose whatever its value."""
    x = rng.random((300, 200)).astype(np.float32)
    np.testing.assert_array_equal(
        tr.transpose_pallas(x, tile, device="cpu").numpy(),
        np.asarray(ref.transpose_pallas(jnp.asarray(x), tile)))


@pytest.mark.parametrize("shape,dtype", [((1024, 2048), np.float32),
                                         ((100, 300), np.float32),
                                         ((64, 48), np.int32)])
def test_transpose_routing_on_cpu(rng, shape, dtype):
    """transpose() equals the reference's; a CPU tensor never reaches the
    kernel's wrapper (on the card every tensor goes through K17)."""
    x = (rng.random(shape) * 100).astype(dtype)
    got = tr.transpose(x, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.transpose(jnp.asarray(x))))
    assert got.is_contiguous()
    assert (tr.TILE, tr.BEST_TILE) == (ref.TILE, ref.BEST_TILE)


def test_kernel_wrapper_on_cpu_is_the_plain_version(rng, monkeypatch):
    monkeypatch.setattr(tr, "TRANSPOSE_LAUNCHES", 0)
    x = torch.from_numpy(rng.random((2048, 1024)).astype(np.float32))
    assert torch.equal(tr.transpose_pallas(x), tr.transpose_pallas_torch(x))
    assert torch.equal(tr.transpose(x), x.t())
    b = x[:37, :53].to(torch.bfloat16)
    assert torch.equal(tr.transpose_pallas(b), b.t())
    with pytest.raises(ValueError):
        tr.transpose_pallas(x[0])
    assert tr.TRANSPOSE_LAUNCHES == 0
