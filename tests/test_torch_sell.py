"""The port's ELL container, ell_spmv and SELL / SELLSplit (K6) against
libhpc_tpu (CPU).

The matrices and tolerances are those of tests/test_ell_pallas.py:22-92
(rtol 1e-4, atol 1e-5), plus a SELLSplit case. Containers must match the
reference array by array; the port's plain path must match scipy, and the
reference (Pallas in interpret mode) on a subset.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops import ell_pallas as ref_sell
from libhpc_tpu.ops import spmv as ref_spmv
from libhpc_tpu.sparse.csr import CSR as RefCSR
from libhpc_tpu.sparse.ell import ELL as RefELL
from libhpc_tpu_torch.ops import spmv, spmv_sell
from libhpc_tpu_torch.ops.spmv_sell import SELL, SELLSplit
from libhpc_tpu_torch.sparse import ELL
from libhpc_tpu_torch.sparse.csr import CSR

from _torch_port import assert_same_container, port_of

RTOL, ATOL = 1e-4, 1e-5


def _banded(n):
    return sps.diags([np.full(n - abs(k), 1.0 + k) for k in (-2, -1, 0, 1, 3)],
                     [-2, -1, 0, 1, 3], shape=(n, n), format="csr",
                     dtype=np.float32)


def _irregular_row_lengths():
    # rows with 0..7 entries, columns within a narrow band
    n = 3000
    rows, cols, vals = [], [], []
    for r in range(n):
        for i in range(r % 8):
            rows.append(r)
            cols.append(min(n - 1, max(0, r + i - 3)))
            vals.append(float(i + 1))
    # f32 values: the reference's CSR stores f64 input as f32 (JAX runs
    # without x64), the port keeps scipy's dtype
    A = sps.coo_matrix((np.asarray(vals, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def _empty_and_zero_rows():
    A = sps.lil_matrix((2048, 2048), dtype=np.float32)
    A[5, 7] = 2.0
    A[2000, 1999] = -3.0
    return A.tocsr()


MATRICES = {
    **{f"banded{n}": (lambda n=n: _banded(n))
       for n in (8, 111, 1000, 1024, 1048, 2500)},
    "poisson48": lambda: matrices.poisson2d(48),
    "poisson64_pane_crossing": lambda: matrices.poisson2d(64),
    "rect": lambda: sps.random(500, 1300, density=0.01, format="csr",
                               dtype=np.float32, random_state=7).tocsr(),
    "irregular_row_lengths": _irregular_row_lengths,
    "empty_and_zero_rows": _empty_and_zero_rows,
    "split_banded20000": lambda: _banded(20000),
}


def _x(n):
    return np.linspace(-1.0, 1.0, n).astype(np.float32)


def _check_walk(sp):
    """tile_order visits each stripe's tiles in stream order, padding
    tiles (sid 0) last in stripe 0, and covers every tile once."""
    order, ptr = sp.tile_order.numpy(), sp.tile_ptr.numpy()
    sid = sp.sid.numpy()
    assert sorted(order) == list(range(sp.n_tiles))
    assert ptr[0] == 0 and ptr[-1] == sp.n_tiles
    for s in range(sp.n_stripes):
        run = order[ptr[s]:ptr[s + 1]]
        assert np.all(sid[run] == s) and np.all(np.diff(run) > 0)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_sell_container_and_spmv(name):
    A = MATRICES[name]()
    ref = ref_sell.sell_from_scipy(A)
    port = spmv_sell.sell_from_scipy(A, device="cpu")
    assert_same_container(port, ref)
    assert_same_container(port_of(ref), ref)
    assert (port.n_tiles, port.hbm_bytes, port.W) == (ref.n_tiles,
                                                      ref.hbm_bytes, ref.W)
    for part in ((port.near, port.wide) if isinstance(port, SELLSplit)
                 else (port,)):
        _check_walk(part)
    x = _x(A.shape[1])
    y = spmv_sell.sell_spmv(port, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (A.shape[0],)
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name, kind", [
    ("banded1000", SELL),                     # single-pane tiles only
    ("poisson64_pane_crossing", SELL),        # merged near + wide, W = 2
    ("irregular_row_lengths", SELL),
    ("split_banded20000", SELLSplit),         # >= TPB near tiles
])
def test_sell_spmv_matches_reference(name, kind):
    A = MATRICES[name]()
    port = spmv_sell.sell_from_scipy(A, device="cpu")
    assert type(port) is kind
    x = _x(A.shape[1])
    y = spmv_sell.sell_spmv(port, torch.from_numpy(x)).numpy()
    y_ref = np.asarray(ref_sell.sell_spmv(ref_sell.sell_from_scipy(A),
                                          jnp.asarray(x)))
    np.testing.assert_allclose(y, y_ref, rtol=RTOL, atol=ATOL)


def test_sell_split_and_merged_kinds():
    """SELLSplit when at least TPB single-pane tiles exist beside the
    multi-pane ones; one merged SELL at the wide span below that."""
    split = spmv_sell.sell_from_scipy(MATRICES["split_banded20000"](),
                                      device="cpu")
    assert isinstance(split, SELLSplit)
    assert split.near.W == 1 and split.W == split.wide.W == 2
    assert split.near.n_tiles >= spmv_sell.TPB
    merged = spmv_sell.sell_from_scipy(MATRICES["poisson64_pane_crossing"](),
                                       device="cpu")
    assert isinstance(merged, SELL) and merged.W == 2
    # near tiles, then wide tiles: the stream is not stripe-major, which
    # is why the kernel walks tile_order
    real = merged.vflat.reshape(merged.n_tiles, -1).any(dim=1).numpy()
    assert np.any(np.diff(merged.sid.numpy()[real]) < 0)


def test_sell_wide_scatter_raises():
    # one entry per row at column 37*r: slice 0's columns span panes 0..4
    rows = np.arange(128)
    A = sps.coo_matrix((np.ones(128, np.float32), (rows, rows * 37)),
                       shape=(128, 8 * 1024)).tocsr()
    with pytest.raises(ValueError, match="SBELL"):
        spmv_sell.sell_from_scipy(A, device="cpu")
    with pytest.raises(ValueError, match="SBELL"):
        ref_sell.sell_from_scipy(A)


def test_sell_empty_and_zero_rows_values():
    A = MATRICES["empty_and_zero_rows"]()
    x = np.arange(2048, dtype=np.float32)
    y = spmv_sell.sell_spmv(spmv_sell.sell_from_scipy(A, device="cpu"),
                            torch.from_numpy(x)).numpy()
    assert y[5] == 14.0
    assert y[2000] == -3.0 * 1999
    assert np.count_nonzero(y) == 2


def test_sell_chains_pane_layout():
    A = matrices.poisson2d(48)
    sp = spmv_sell.sell_from_scipy(A, device="cpu")
    x = torch.from_numpy(_x(A.shape[1]))
    y2 = spmv_sell.sell_spmv(sp, spmv_sell.sell_spmv(sp, x)).numpy()
    np.testing.assert_allclose(y2, A @ (A @ x.numpy()), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["poisson48", "rect", "irregular_row_lengths",
                                  "empty_and_zero_rows"])
def test_ell_container_and_spmv(name):
    A = MATRICES[name]()
    ref = RefELL.from_scipy(A)
    port = ELL.from_scipy(A, device="cpu")
    assert_same_container(port, ref)
    assert port.k == ref.k and port.dtype == torch.float32
    assert_same_container(
        CSR.from_scipy(A, device="cpu").to_ell(pad_multiple=4),
        RefCSR.from_scipy(A).to_ell(pad_multiple=4))
    np.testing.assert_array_equal(port.todense().numpy(), A.toarray())
    np.testing.assert_array_equal(port.to_scipy().toarray(), A.toarray())
    x = _x(A.shape[1])
    y = spmv.ell_spmv(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, A @ x, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        y, np.asarray(ref_spmv.ell_spmv(ref, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


def test_ell_row_cap_and_empty():
    A = MATRICES["irregular_row_lengths"]()
    csr = CSR.from_scipy(A, device="cpu")
    with pytest.raises(ValueError, match="entries would be dropped"):
        csr.to_ell(max_nnz_per_row=5)
    wide = csr.to_ell(max_nnz_per_row=9)
    assert wide.k == 16
    assert_same_container(wide, RefCSR.from_scipy(A).to_ell(9))
    empty = ELL.from_scipy(sps.csr_matrix((300, 40), dtype=np.float32),
                           device="cpu")
    assert_same_container(
        empty, RefELL.from_scipy(sps.csr_matrix((300, 40), dtype=np.float32)))
    assert empty.k == 1 and not torch.any(empty.vals)
