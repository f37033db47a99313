"""The port's SELL-P container and SpMV (K7) against libhpc_tpu (CPU).

The matrices and tolerances are those of tests/test_sellp.py:26-87 (rtol
1e-4, atol 1e-4). Containers must match the reference array by array; the
port's plain path must match scipy, and the reference (Pallas in interpret
mode) on a subset. The reference's VMEM guard (test_sellp_vmem_guard) has
no counterpart: the Hopper kernel reads x from global memory.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops import sellp as ref_sellp
from libhpc_tpu_torch.ops import sellp

from _torch_port import assert_same_container, port_of

RTOL, ATOL = 1e-4, 1e-4


def _no_window_restriction():
    n = 8192
    rng = np.random.default_rng(8)
    rows = np.arange(n).repeat(2)
    cols = np.concatenate([np.arange(n)[:, None],
                           rng.integers(0, n, (n, 1))], axis=1).ravel()
    A = sps.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def _empty_rows_and_multiplicity():
    n = 4096
    rows = np.concatenate([np.zeros(20, np.int64),
                           np.arange(2048, 2068, dtype=np.int64)])
    cols = np.concatenate([np.arange(0, 160, 8, dtype=np.int64),
                           np.arange(0, 160, 8, dtype=np.int64)])
    vals = np.linspace(1, 2, rows.size).astype(np.float32)
    return sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


# name -> (matrix, fill bound of the reference test or None)
MATRICES = {
    "poisson96": (lambda: matrices.poisson2d(96), 3.0),
    "banded_offsets": (lambda: sps.diags(
        [np.ones(9000 - k) for k in (0, 1, 2, 3)], [0, -1, 2, 17],
        shape=(9000, 9000), format="csr"), 2.5),
    "fem_blocks": (lambda: matrices.block_random(
        300, block=8, blocks_per_row=5, seed=3, half_band=4,
        far_fraction=0.02), 4.0),
    "no_window_restriction": (_no_window_restriction, None),
    "rectangular_and_ragged": (lambda: sps.random(
        1111, 2222, density=0.004, random_state=6, format="csr",
        dtype=np.float32), None),
    "empty_rows_and_multiplicity": (_empty_rows_and_multiplicity, None),
}


def _x(n):
    return np.linspace(-1.0, 1.0, n).astype(np.float32)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_sellp_container_and_spmv(name):
    make, fill_below = MATRICES[name]
    A = sps.csr_matrix(make(), dtype=np.float32)
    ref = ref_sellp.sellp_from_scipy(A)
    port = sellp.sellp_from_scipy(A, device="cpu")
    assert_same_container(port, ref)
    assert_same_container(port_of(ref), ref)
    assert (port.n_tiles, port.hbm_bytes) == (ref.n_tiles, ref.hbm_bytes)
    assert port.fill_ratio(A.nnz) == ref.fill_ratio(A.nnz)
    if fill_below is not None:
        assert port.fill_ratio(A.nnz) < fill_below
    # the kernel's walk: each stripe's tiles in stream order, once each
    order, ptr = port.tile_order.numpy(), port.tile_ptr.numpy()
    sid = port.sid.numpy()
    assert sorted(order) == list(range(port.n_tiles))
    for s in range(port.n_stripes):
        run = order[ptr[s]:ptr[s + 1]]
        assert np.all(sid[run] == s) and np.all(np.diff(run) > 0)
    x = _x(A.shape[1])
    y = sellp.sellp_spmv(port, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (A.shape[0],)
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["poisson96", "empty_rows_and_multiplicity"])
def test_sellp_spmv_matches_reference(name):
    A = sps.csr_matrix(MATRICES[name][0](), dtype=np.float32)
    x = _x(A.shape[1])
    y = sellp.sellp_spmv(sellp.sellp_from_scipy(A, device="cpu"),
                         torch.from_numpy(x)).numpy()
    y_ref = np.asarray(ref_sellp.sellp_spmv(ref_sellp.sellp_from_scipy(A),
                                            jnp.asarray(x)))
    np.testing.assert_allclose(y, y_ref, rtol=RTOL, atol=ATOL)


def test_sellp_tiles_interleave_across_stripes():
    """The reference's tile stream is round-robin across stripes (tile k
    of every stripe before tile k+1); the port keeps it."""
    sp = sellp.sellp_from_scipy(matrices.poisson2d(64), device="cpu")
    sid = sp.sid.numpy()[:sp.tile_ptr.numpy()[-1]]
    assert sp.n_stripes > 1 and np.any(np.diff(sid) < 0)


def test_sellp_chains_with_pane_layout():
    A = matrices.poisson2d(64)
    sp = sellp.sellp_from_scipy(A, device="cpu")
    x = torch.from_numpy(_x(A.shape[1]))
    y2 = sellp.sellp_spmv(sp, sellp.sellp_spmv(sp, x)).numpy()
    np.testing.assert_allclose(y2, A @ (A @ x.numpy()), rtol=1e-3, atol=1e-3)
