"""The port's SBELL container and SpMV against libhpc_tpu (CPU).

The same scipy matrices go through the reference (Pallas in interpret mode
on the CPU, as its own tests run it) and through the port's plain path.
Containers must match array by array; SpMV results must match the
reference and the scipy oracle at the reference's own tolerances
(tests/test_spmv_pallas.py:19).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops import spmv_pallas as ref_spmv
from libhpc_tpu.sparse.sbell import SBELL as RefSBELL
from libhpc_tpu_torch.ops import spmv_sbell
from libhpc_tpu_torch.sparse.sbell import LANE, FarBlocks, FarPane
from libhpc_tpu_torch.sparse.sbell import SBELL

from _torch_port import assert_same_container, port_of

RTOL, ATOL = 1e-4, 1e-5


def _random(n):
    A = sps.random(n, n, density=min(0.05, 2000 / (n * n) + 0.001),
                   format="csr", dtype=np.float32, random_state=42)
    A.setdiag(1.0)
    return A.tocsr()


def _multi_pane_spread():
    n = 6000
    rows = np.repeat(np.arange(n), 3)
    cols = np.concatenate([np.arange(n), (np.arange(n) * 977) % n,
                           (np.arange(n) * 31 + 17) % n])
    A = sps.coo_matrix((np.ones(cols.size, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def _empty_rows():
    A = sps.lil_matrix((1024, 1024), dtype=np.float32)
    A[5, 7] = 2.0
    return A.tocsr()


def _duplicate_block_cols():
    return sps.csr_matrix(
        (np.array([1.0, 2.0, 3.0], np.float32),
         (np.array([0, 0, 0]), np.array([0, 200, 4000]))), shape=(128, 8192))


MATRICES = {
    "random8": lambda: _random(8),
    "random1000": lambda: _random(1000),
    "random1048": lambda: _random(1048),
    "random2500": lambda: _random(2500),
    "rect": lambda: sps.random(500, 1300, density=0.01, format="csr",
                               dtype=np.float32, random_state=7),
    "block_structured": lambda: matrices.block_random(
        400, block=8, blocks_per_row=8, seed=3, far_fraction=0.0),
    "far_split": lambda: matrices.block_random(
        400, block=8, blocks_per_row=8, seed=3, far_fraction=0.3),
    "poisson2d_64": lambda: matrices.poisson2d(64),
    "multi_pane_spread": _multi_pane_spread,
    "empty_rows": _empty_rows,
    "duplicate_block_cols": _duplicate_block_cols,
}


def _x(n):
    return np.linspace(-1.0, 1.0, n).astype(np.float32)


def _quantized(A):
    Aq = A.copy()
    Aq.data = torch.from_numpy(A.data).to(torch.bfloat16).float().numpy()
    return Aq


def _check_tile_ptr(sb):
    """tile_ptr[s+1]-tile_ptr[s] counts stripe s's real tiles, and the
    ranges cover exactly the tiles whose sid is s."""
    ptr = sb.tile_ptr.numpy()
    sid = sb.sid.numpy()
    assert ptr[0] == 0 and np.all(np.diff(ptr) >= 0)
    assert sb.k_max == (int(np.diff(ptr).max()) if sb.n_stripes else 0)
    for s in range(sb.n_stripes):
        assert np.all(sid[ptr[s]:ptr[s + 1]] == s)
    assert torch.all(sb.vflat.reshape(sb.n_tiles, -1)[ptr[-1]:] == 0)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_container_parity(name):
    A = MATRICES[name]()
    ref = RefSBELL.from_scipy(A)
    port = SBELL.from_scipy(A, device="cpu")
    assert_same_container(port, ref)
    _check_tile_ptr(port)
    # from_numpy of the reference's leaves builds the same container,
    # derived fields included
    assert_same_container(port_of(ref), ref)
    assert torch.equal(port_of(ref).tile_ptr, port.tile_ptr)
    if isinstance(port.far, FarPane):
        assert torch.equal(port_of(ref).far.olane, port.far.olane)
    assert port.hbm_bytes == ref.hbm_bytes
    assert port.nnz_stored == ref.nnz_stored
    assert port.far_fraction == ref.far_fraction
    assert port.fill_ratio(A.nnz) == ref.fill_ratio(A.nnz)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmv_parity(name):
    A = MATRICES[name]()
    x = _x(A.shape[1])
    y_ref = np.asarray(ref_spmv.sbell_spmv(RefSBELL.from_scipy(A),
                                           jnp.asarray(x)))
    y = spmv_sbell.sbell_spmv(SBELL.from_scipy(A, device="cpu"),
                              torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (A.shape[0],)
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=RTOL, atol=ATOL)


def test_far_set_kinds():
    """FarPane by default, flat FarBlocks with group_far=False, and the
    FarBlocks fallback when one stripe holds more than LANE far blocks."""
    far_split = MATRICES["far_split"]()
    assert isinstance(SBELL.from_scipy(far_split, device="cpu").far, FarPane)
    flat_ref = RefSBELL.from_scipy(far_split, group_far=False)
    flat = SBELL.from_scipy(far_split, group_far=False, device="cpu")
    assert isinstance(flat.far, FarBlocks)
    assert_same_container(flat, flat_ref)
    spread = _multi_pane_spread()
    sb = SBELL.from_scipy(spread, device="cpu")
    assert isinstance(sb.far, FarBlocks)
    rows = sb.far.rows.numpy()
    assert np.bincount(rows // LANE).max() > LANE
    x = _x(far_split.shape[1])
    y = spmv_sbell.sbell_spmv(flat, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, far_split @ x, rtol=RTOL, atol=ATOL)


def test_astype_bf16_and_retile():
    """bf16 values (near planes and FarPane bt, one-hot stays f32) with the
    retile to tpb=32, and an explicit retile, match the reference bit for
    bit; the bf16 SpMV matches the quantized operator and the reference."""
    A = matrices.block_random(260, block=8, blocks_per_row=6, seed=21,
                              half_band=5, far_fraction=0.05)
    ref = RefSBELL.from_scipy(A)
    port = SBELL.from_scipy(A, device="cpu")
    ref16 = ref.astype_values(jnp.bfloat16)
    p16 = port.astype_values(torch.bfloat16)
    assert p16.tpb == ref16.tpb == 32
    assert p16.vflat.dtype == torch.bfloat16
    assert p16.far.bt.dtype == torch.bfloat16
    assert p16.far.oh.dtype == torch.float32
    assert_same_container(p16, ref16)
    assert_same_container(port_of(ref16), ref16)
    assert p16.hbm_bytes == ref16.hbm_bytes < port.hbm_bytes
    assert torch.equal(p16.tile_ptr, port.tile_ptr)
    assert_same_container(port.retile(64), ref.retile(64))

    x = _x(A.shape[1])
    y16 = spmv_sbell.sbell_spmv(p16, torch.from_numpy(x)).numpy()
    y16_ref = np.asarray(ref_spmv.sbell_spmv(ref16, jnp.asarray(x)))
    np.testing.assert_allclose(y16, _quantized(A) @ x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y16, y16_ref, rtol=1e-4, atol=1e-4)
    y64 = spmv_sbell.sbell_spmv(port.retile(64), torch.from_numpy(x))
    np.testing.assert_allclose(y64.numpy(), A @ x, rtol=RTOL, atol=ATOL)


def test_from_numpy_round_trip():
    A = MATRICES["far_split"]()
    port = SBELL.from_scipy(A, device="cpu")
    far = type(port.far).from_numpy(port.far.to_numpy(),
                                    **port.far.statics())
    again = SBELL.from_numpy(port.to_numpy(), far=far, **port.statics())
    for k, v in port.to_numpy().items():
        assert np.array_equal(again.to_numpy()[k], v), k
    for k, v in port.far.to_numpy().items():
        assert np.array_equal(again.far.to_numpy()[k], v), k
    assert torch.equal(again.tile_ptr, port.tile_ptr)
    assert again.device == torch.device("cpu")


def test_forced_chunked_reference(monkeypatch):
    """The reference's row-chunked path (the ranged kernel, K2) forced with
    a tiny VMEM cap, as tests/test_spmv_pallas.py:105-128 does; the port's
    single kernel path must match it."""
    A = matrices.block_random(2000, block=8, blocks_per_row=6, seed=5,
                              half_band=4, far_fraction=0.02)
    x = _x(A.shape[1])
    monkeypatch.setattr(ref_spmv, "VMEM_CAP", 60_000)
    ref = RefSBELL.from_scipy(A)
    y_ref = np.asarray(ref_spmv.sbell_spmv(ref, jnp.asarray(x)))
    assert len(ref_spmv._chunk_plan(ref)[3]) > 1      # actually chunked
    y = spmv_sbell.sbell_spmv(SBELL.from_scipy(A, device="cpu"),
                              torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=RTOL, atol=ATOL)


def test_spmv_padded_domain():
    A = matrices.block_random(150, block=8, blocks_per_row=5, seed=9,
                              half_band=5, far_fraction=0.05)
    m, n = A.shape
    sb = SBELL.from_scipy(A, device="cpu")
    xpad = np.pad(_x(n), (0, sb.n_panes * 1024 - n))
    ypad = spmv_sbell.sbell_spmv_padded(sb, torch.from_numpy(xpad)).numpy()
    assert ypad.shape == (sb.n_stripes * 1024,)
    assert np.all(ypad[m:] == 0.0)
    np.testing.assert_allclose(ypad[:m], A @ _x(n), rtol=RTOL, atol=ATOL)
    y_ref = np.asarray(ref_spmv.sbell_spmv_padded(RefSBELL.from_scipy(A),
                                                  jnp.asarray(xpad)))
    np.testing.assert_allclose(ypad, y_ref, rtol=RTOL, atol=ATOL)


def test_spmv_panes_chain():
    """Two matvecs in the guarded pane layout equal A @ (A @ x)
    (tests/test_spmv_pallas.py:184-209) and the reference's chain."""
    A = matrices.block_random(260, block=8, blocks_per_row=5, seed=13,
                              half_band=5, far_fraction=0.04)
    m, n = A.shape
    sb = SBELL.from_scipy(A, device="cpu")
    xpad = np.pad(_x(n), (0, sb.n_panes * 1024 - n))
    x3 = spmv_sbell.x_to_panes(sb, torch.from_numpy(xpad))
    assert x3.shape == (sb.n_panes + 2, 8, 128)
    o3 = spmv_sbell.sbell_spmv_panes(sb, x3)
    assert o3.shape == (sb.n_stripes + 2, 8, 128)
    assert torch.all(o3[sb.n_stripes:] == 0)
    o6 = spmv_sbell.sbell_spmv_panes(sb, o3)
    y2 = spmv_sbell.panes_to_x(sb, o6).numpy()[:m]
    Ap = A.copy()
    Ap.resize((sb.n_stripes * 1024, sb.n_panes * 1024))
    np.testing.assert_allclose(y2, (Ap @ (Ap @ xpad))[:m], rtol=1e-3,
                               atol=1e-4)
    ref = RefSBELL.from_scipy(A)
    r3 = ref_spmv.x_to_panes(ref, jnp.asarray(xpad))
    r6 = ref_spmv.sbell_spmv_panes(ref, ref_spmv.sbell_spmv_panes(ref, r3))
    np.testing.assert_allclose(o6.numpy(), np.asarray(r6), rtol=1e-3,
                               atol=1e-4)
