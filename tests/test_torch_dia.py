"""The port's DIA container, dia_spmv / dia_spmv_t and the streaming DIA
operand (DiaPallas, K4 and its probe K5) against libhpc_tpu (CPU).

The matrices and tolerances are those of tests/test_dia_pallas.py:23-96
(T = 2^13, rtol 1e-4, atol 1e-4). Containers must match the reference array
by array; the port's plain path must match the reference (Pallas in
interpret mode) and scipy.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops import dia_pallas as ref_dp
from libhpc_tpu.ops import spmv as ref_spmv
from libhpc_tpu.sparse.dia import DIA as RefDIA
from libhpc_tpu_torch.ops import spmv, spmv_dia
from libhpc_tpu_torch.ops.spmv_dia import LANE, DiaPallas
from libhpc_tpu_torch.sparse import DIA
from libhpc_tpu_torch.sparse.csr import CSR

from _torch_port import assert_same_container, port_of

T_TEST = 1 << 13
RTOL, ATOL = 1e-4, 1e-4


def _banded(n):
    return sps.diags(
        [np.full(n - abs(o), 1.0 + o) for o in (-70, -1, 0, 1, 65)],
        [-70, -1, 0, 1, 65], shape=(n, n), format="csr", dtype=np.float32)


MATRICES = {
    "banded1000": lambda: _banded(1000),
    "banded8192": lambda: _banded(8192),
    "banded9000": lambda: _banded(9000),
    "banded40000": lambda: _banded(40000),
    "poisson96": lambda: matrices.poisson2d(96),
    "wide_offsets": lambda: sps.diags(
        [np.ones(50000 - 9000), np.ones(50000), np.ones(50000 - 12288)],
        [-9000, 0, 12288], shape=(50000, 50000), format="csr",
        dtype=np.float32),
    "multi_tile_poisson128": lambda: matrices.poisson2d(128),
    "rect": lambda: sps.diags([np.ones(5000), np.ones(5000)], [0, 1500],
                              shape=(5000, 7000), format="csr",
                              dtype=np.float32),
    "wide_rect": lambda: sps.diags([np.ones(1000)], [0], shape=(1000, 200000),
                                   format="csr", dtype=np.float32),
}


def _x(n):
    return np.linspace(-1.0, 1.0, n).astype(np.float32)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dia_containers_and_spmv(name):
    """DIA and DiaPallas equal the reference's; the DiaPallas matvec (the
    kernel wrapper's plain path) and dia_spmv match scipy."""
    A = MATRICES[name]()
    ref = RefDIA.from_scipy(A)
    port = DIA.from_scipy(A, device="cpu")
    assert_same_container(port, ref)
    assert_same_container(port_of(ref), ref)
    assert (port.ndiags, port.nnz_stored) == (ref.ndiags, ref.nnz_stored)
    rdp = ref_dp.DiaPallas.from_dia(ref, T=T_TEST)
    dp = DiaPallas.from_dia(port, T=T_TEST, device="cpu")
    assert_same_container(dp, rdp)
    assert (dp.n_tiles, dp.hbm_bytes) == (rdp.n_tiles, rdp.hbm_bytes)
    x = _x(A.shape[1])
    want = A @ x
    y = spmv_dia.dia_spmv_pallas(dp, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (A.shape[0],)
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(spmv.dia_spmv(port, torch.from_numpy(x))
                               .numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dia_spmv_pallas_matches_reference(name):
    """The reference's DIA kernel in interpret mode and the port's plain
    path, on multi-tile, lane-unaligned and wide-rectangular operands."""
    A = MATRICES[name]()
    x = _x(A.shape[1])
    y_ref = np.asarray(ref_dp.dia_spmv_pallas(
        ref_dp.DiaPallas.from_dia(RefDIA.from_scipy(A), T=T_TEST),
        jnp.asarray(x)))
    y = spmv_dia.dia_spmv_pallas(
        DIA.from_scipy(A, device="cpu").to_pallas(T=T_TEST),
                                 torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=RTOL, atol=ATOL)


def test_wide_rect_x_ext_length():
    """ncols far beyond the diagonals' reach: x_ext must hold all of x
    (the negative-pad regression of tests/test_dia_pallas.py:56-61)."""
    dp = DIA.from_scipy(MATRICES["wide_rect"](),
                        device="cpu").to_pallas(T=T_TEST)
    L = spmv_dia.x_ext_len(dp)
    assert L == -(-(dp.x_pad_lo + 200000) // LANE) * LANE
    assert L > dp.x_pad_lo + dp.n_tiles * dp.T + dp.span_pad
    x_ext = spmv_dia.extend_x(dp, torch.ones(200000))
    assert x_ext.shape == (L,) and float(x_ext.sum()) == 200000.0


@pytest.mark.parametrize("name", ["banded1000", "poisson96", "rect",
                                  "wide_offsets"])
def test_dia_spmv_and_transpose_match_reference(name):
    A = MATRICES[name]()
    ref, port = RefDIA.from_scipy(A), DIA.from_scipy(A, device="cpu")
    x = _x(A.shape[1])
    y = np.random.default_rng(3).standard_normal(A.shape[0]) \
        .astype(np.float32)
    got = spmv.dia_spmv(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref_spmv.dia_spmv(ref, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((port @ torch.from_numpy(x)).numpy(), got)
    got_t = spmv.dia_spmv_t(port, torch.from_numpy(y)).numpy()
    assert got_t.shape == (A.shape[1],)
    np.testing.assert_allclose(got_t, A.T @ y, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got_t, np.asarray(ref_spmv.dia_spmv_t(ref, jnp.asarray(y))),
        rtol=1e-5, atol=1e-6)


def test_dia_guard_offsets():
    n = 400
    offs = list(range(-60, 61))            # 121 offsets > MAX_DIA_OFFSETS
    A = sps.diags([np.ones(n - abs(o)) for o in offs], offs, shape=(n, n),
                  format="csr", dtype=np.float32)
    dia = DIA.from_scipy(A, device="cpu")
    assert dia.ndiags == 121 > spmv.MAX_DIA_OFFSETS
    with pytest.raises(ValueError, match="compile-safety cap"):
        spmv.dia_spmv(dia, torch.zeros(n))
    with pytest.raises(ValueError, match="compile-safety cap"):
        spmv.dia_spmv_t(dia, torch.zeros(n))


def test_dia_conversions():
    """from_csr, to_scipy, todense and a narrow scipy data array (padded
    to ncols, dia.py:50-51); data keeps scipy's dtype."""
    A = MATRICES["rect"]()
    dia = DIA.from_csr(CSR.from_scipy(A, device="cpu"))
    assert dia.data.shape == (2, 7000) and dia.dtype == torch.float32
    np.testing.assert_array_equal(dia.to_scipy().toarray(), A.toarray())
    np.testing.assert_array_equal(dia.todense().numpy(), A.toarray())
    narrow = sps.dia_matrix((np.ones((1, 3), np.float64), [0]),
                            shape=(5, 8))
    d64 = DIA.from_scipy(narrow, device="cpu")
    assert d64.data.shape == (1, 8) and d64.dtype == torch.float64
    np.testing.assert_array_equal(d64.todense().numpy(), narrow.toarray())


def test_dia_pattern_probe_matches_model():
    """The probe touches the kernel's operands: out = two window reads +
    the sum of the tile's planes (the numpy oracle of
    tests/test_dia_pallas.py:64-96), and equals the reference's probe."""
    A = matrices.poisson2d(64)
    dp = DIA.from_scipy(A, device="cpu").to_pallas(T=1 << 12)
    n = A.shape[1]
    x = np.linspace(-1, 1, n).astype(np.float32)
    out = spmv_dia.dia_pattern_probe(dp, torch.from_numpy(x)).numpy()
    assert np.isfinite(out).all()
    D = len(dp.coffs)
    Tr = dp.T // LANE
    sr = dp.span_pad // LANE
    n_tiles = dp.n_tiles
    L = max(dp.x_pad_lo + n_tiles * dp.T + dp.span_pad,
            -(-(dp.x_pad_lo + n) // LANE) * LANE)
    xe = np.zeros(L, np.float32)
    xe[dp.x_pad_lo:dp.x_pad_lo + n] = x
    x2 = xe.reshape(-1, LANE)
    dflat = dp.dflat.numpy().reshape(n_tiles, D, Tr, LANE)
    for g in range(n_tiles):
        exp = (x2[g * Tr:g * Tr + Tr]
               + x2[g * Tr + sr:g * Tr + sr + Tr]
               + dflat[g].sum(axis=0))
        np.testing.assert_allclose(out[g * Tr:(g + 1) * Tr], exp,
                                   rtol=1e-5, atol=1e-5)
    rdp = ref_dp.DiaPallas.from_dia(RefDIA.from_scipy(A), T=1 << 12)
    np.testing.assert_allclose(
        out, np.asarray(ref_dp.dia_pattern_probe(rdp, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
