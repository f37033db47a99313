"""The port's tiled matmul (libhpc_tpu_torch/ops/matmul.py) against
libhpc_tpu/ops/matmul.py (CPU; the reference's Pallas kernel in interpret
mode, the port's plain version). Shapes and tolerance are
tests/test_histogram_transpose.py's: rtol 1e-4, atol 1e-3 (float32 sums in
another order), at its tiles of 128. Also the operand plans of the
tensor-core kernel (``tma_operands``) and of the FMA kernel
(``fma_operands``) and the FMA kernel's tile rule (``fma_tile``), which run
on the CPU too.
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


def _half_case(rng, jdt, tdt):
    """The reference's and the port's product of the same half-width
    operands (96 x 160 @ 160 x 72), with the port's operands."""
    a = rng.random((96, 160)).astype(np.float32)
    b = rng.random((160, 72)).astype(np.float32)
    ab = jnp.asarray(a, jdt)
    bb = jnp.asarray(b, jdt)
    want = np.asarray(ref_matmul(ab, bb, **TILES).astype(jnp.float32))
    ta = torch.from_numpy(np.array(ab.astype(jnp.float32))).to(tdt)
    tb = torch.from_numpy(np.array(bb.astype(jnp.float32))).to(tdt)
    got = mm.matmul_pallas(ta, tb, **TILES)
    assert got.dtype == tdt
    return got, want, ta, tb


def test_matmul_pallas_bf16(rng):
    """bfloat16 operands: float32 accumulation, a bfloat16 result equal to
    the reference's to one bfloat16 rounding."""
    got, want, ta, tb = _half_case(rng, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3, atol=0)
    exact = ta.double() @ tb.double()
    np.testing.assert_allclose(got.float().numpy(), exact.numpy(), rtol=8e-3)


def test_matmul_pallas_f16(rng):
    """float16 operands, at the bfloat16 test's shape and tolerance: the
    reference in interpret mode takes float16 on the CPU."""
    got, want, ta, tb = _half_case(rng, jnp.float16, torch.float16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3, atol=0)
    exact = ta.double() @ tb.double()
    np.testing.assert_allclose(got.float().numpy(), exact.numpy(), rtol=8e-3)


@pytest.mark.parametrize("m,k,n", [(129, 7, 1), (1, 1000, 1),
                                   (1030, 770, 513), (8, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tma_operands(rng, m, k, n, dtype):
    """The tensor-core kernel's operand plan: A and B^T with K padded with
    zeros to a multiple of 8 and 16-byte-aligned starts; their product is
    the unpadded one (the padding adds exact zeros)."""
    a = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(dtype)
    at, bt = mm.tma_operands(a, b)
    kp = -(-k // 8) * 8
    assert at.shape == (m, kp) and bt.shape == (n, kp)
    assert at.dtype == bt.dtype == dtype
    assert at.is_contiguous() and bt.is_contiguous()
    assert at.data_ptr() % 16 == 0 and bt.data_ptr() % 16 == 0
    assert not at[:, k:].any() and not bt[:, k:].any()
    torch.testing.assert_close(at.double() @ bt.double().T,
                               a.double() @ b.double(), rtol=1e-12,
                               atol=1e-12)


def test_tma_operands_realign_an_offset_view():
    """A contiguous view that starts 2 bytes into its storage is copied to
    an aligned tensor; K = 16 needs no padding."""
    base = torch.arange(1 + 40 * 16, dtype=torch.float32).to(torch.bfloat16)
    a = base[1:].view(40, 16)
    assert a.data_ptr() % 16 != 0
    b = torch.ones((16, 3), dtype=torch.bfloat16)
    at, bt = mm.tma_operands(a, b)
    assert at.data_ptr() % 16 == 0 and torch.equal(at, a)
    assert torch.equal(bt, b.t())


@pytest.mark.parametrize("m,k,n", [(129, 7, 1), (1, 1000, 1),
                                   (1030, 770, 513), (8, 8, 8)])
def test_fma_operands(rng, m, k, n):
    """The FMA kernel's operand plan: A^T (K, M4) and B (K, N4), M and N
    padded with zeros to multiples of 4, K not padded, contiguous and
    16-byte aligned; the product of the plan equals the plain version and
    the reference's kernel (interpret mode) at the reference's tolerance."""
    a = rng.standard_normal((m, k), np.float32)
    b = rng.standard_normal((k, n), np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    at, bp = mm.fma_operands(ta, tb)
    m4, n4 = -(-m // 4) * 4, -(-n // 4) * 4
    assert at.shape == (k, m4) and bp.shape == (k, n4)
    assert at.dtype == bp.dtype == torch.float32
    assert at.is_contiguous() and bp.is_contiguous()
    assert at.data_ptr() % 16 == 0 and bp.data_ptr() % 16 == 0
    assert not at[:, m:].any() and not bp[:, n:].any()
    assert torch.equal(at[:, :m], ta.t()) and torch.equal(bp[:, :n], tb)
    got = (at.t() @ bp)[:m, :n]
    torch.testing.assert_close(got, mm.matmul_pallas_torch(ta, tb), **TOL)
    want = np.asarray(ref_matmul(jnp.asarray(a), jnp.asarray(b),
                                 tile_m=256, tile_n=256, tile_k=512))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fma_operands_realign_an_offset_view():
    """A contiguous B that starts 4 bytes into its storage is copied to an
    aligned tensor (N = 16 needs no padding); A goes through the
    transpose, a fresh tensor."""
    base = torch.arange(1 + 40 * 16, dtype=torch.float32)
    b = base[1:].view(40, 16)
    assert b.data_ptr() % 16 != 0
    a = base[1:1 + 3 * 40].view(3, 40)
    at, bp = mm.fma_operands(a, b)
    assert bp.data_ptr() % 16 == 0 and torch.equal(bp, b)
    assert at.data_ptr() % 16 == 0 and torch.equal(at[:, :3], a.t())
    assert at.shape == (40, 4) and not at[:, 3].any()


@pytest.mark.parametrize("m,n,sms,tile", [
    (1024, 1024, 132, 64), (8192, 8192, 132, 128), (2048, 2048, 132, 128),
    (1408, 1536, 132, 128), (1408, 1408, 132, 64), (1, 1, 132, 64),
    (1024, 1024, 64, 128)])
def test_fma_tile(m, n, sms, tile):
    """128 x 128 tiles unless they number fewer than the card's SMs."""
    assert mm.fma_tile(m, n, sms) == tile


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_matmul_k0_is_zeros(dtype):
    """K = 0: a zero (M, N) product of the operands' dtype."""
    got = mm.matmul_pallas(torch.zeros((130, 0), dtype=dtype),
                           torch.zeros((0, 5), dtype=dtype))
    assert got.dtype == dtype and got.shape == (130, 5)
    assert not got.any()


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
