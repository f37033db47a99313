"""The port's auto_format against libhpc_tpu's (CPU): the same matrix must
get the same container class with the same fields, and the returned matvec
must match scipy at the reference's 2e-3 (tests/test_auto_format.py).

Every matrix of tests/test_auto_format.py is here, the 10M-nnz route-only
case included (with the port's own terminal constructors patched), plus a
SELL-P route and the DiaPallas route (both modules' _DIA_VMEM_BYTES patched
small, so that no 100 MB matrix is built on the CPU).
"""

import resource

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import libhpc_tpu.ops.ell_pallas as ref_ell_mod
import libhpc_tpu.sparse.auto as ref_auto
import libhpc_tpu.sparse.sbell as ref_sbell_mod
from libhpc_tpu.bench import matrices
from libhpc_tpu_torch.ops import spmv_sell
from libhpc_tpu_torch.sparse import auto
from libhpc_tpu_torch.sparse import sbell as sbell_mod

from _torch_port import assert_same_container

TOL = 2e-3


def _irregular_banded():
    # many distinct diagonals, narrow band, regular-ish: SELL-P fragments,
    # the window SELL packs it
    n = 4000
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(n), 4)
    cols = np.clip(rows + rng.integers(-120, 121, rows.size), 0, n - 1)
    A = sps.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def _scattered_dia_candidate():
    # ~3 nnz per diagonal scattered along 8 long offsets -> fill ~1e-5
    n = 200_000
    rng = np.random.default_rng(1)
    offs = np.array([0, 17, -9931, 45001, -120007, 8888, 3, -1])
    rows, cols = [], []
    for o in offs:
        r = rng.integers(max(0, -o), min(n, n - o), 40)
        rows.append(r)
        cols.append(r + o)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    A = sps.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def _spread_diagonals():
    # 101 full diagonals 9 apart: too many for DIA, not 8x8-block dense,
    # and every (pane, sublane) bucket full — SELL-P
    n = 4096
    offs = [9 * k - 450 for k in range(101)]
    return sps.diags([np.full(n - abs(o), 1.0 + 0.01 * k, np.float32)
                      for k, o in enumerate(offs)], offs, shape=(n, n),
                     format="csr", dtype=np.float32)


# name -> (matrix, the reference's container class)
MATRICES = {
    "poisson64": (lambda: matrices.poisson2d(64), "DIA"),
    "fem": (lambda: matrices.block_random(200, block=8, blocks_per_row=6,
                                          seed=2, half_band=5,
                                          far_fraction=0.05), "SBELL"),
    "irregular_banded": (_irregular_banded, "SELL"),
    "scattered_dia_candidate": (_scattered_dia_candidate, "SBELL"),
    "spread_diagonals": (_spread_diagonals, "SELLP"),
}


def _x(n):
    return np.linspace(-1, 1, n).astype(np.float32)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_auto_same_container(name):
    make, kind = MATRICES[name]
    A = make()
    ref, _ = ref_auto.auto_format(A)
    port, mv = auto.auto_format(A, device="cpu")
    assert type(ref).__name__ == kind
    assert_same_container(port, ref)
    assert port.device == torch.device("cpu")
    x = _x(A.shape[1])
    y = mv(port, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (A.shape[0],)
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=TOL, atol=TOL)


def test_auto_poisson_dia_matvec_matches_reference():
    A = matrices.poisson2d(64)
    ref, ref_mv = ref_auto.auto_format(A)
    port, mv = auto.auto_format(A, device="cpu")
    x = _x(A.shape[1])
    np.testing.assert_allclose(mv(port, torch.from_numpy(x)).numpy(),
                               np.asarray(ref_mv(ref, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_auto_dia_pallas_route(monkeypatch):
    """Past the DIA working-set threshold both route to DiaPallas at the
    default T = 2^17; the threshold is patched down on both sides."""
    monkeypatch.setattr(ref_auto, "_DIA_VMEM_BYTES", 1024)
    monkeypatch.setattr(auto, "_DIA_VMEM_BYTES", 1024)
    A = matrices.poisson2d(96)
    ref, ref_mv = ref_auto.auto_format(A)
    port, mv = auto.auto_format(A, device="cpu")
    assert type(ref).__name__ == type(port).__name__ == "DiaPallas"
    assert port.T == 1 << 17
    assert_same_container(port, ref)
    x = _x(A.shape[1])
    y = mv(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, A @ x, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y, np.asarray(ref_mv(ref, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_auto_bf16():
    A = matrices.block_random(150, block=8, blocks_per_row=5, seed=3,
                              half_band=4)
    ref, _ = ref_auto.auto_format(A, prefer_bf16=True)
    port, mv = auto.auto_format(A, prefer_bf16=True, device="cpu")
    assert port.vflat.dtype == torch.bfloat16
    assert_same_container(port, ref)
    x = _x(A.shape[1])
    Aq = A.copy()
    Aq.data = torch.from_numpy(A.data).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(mv(port, torch.from_numpy(x)).numpy(),
                               Aq @ x, rtol=TOL, atol=TOL)


class _Stop(Exception):
    pass


def _route(fn, A, sbell_cls, sell_mod):
    """Run an auto_format with its terminal SBELL / SELL constructors
    patched to record the route and stop."""
    route = {}

    def stop(fmt):
        def f(*a, **k):
            route["fmt"] = fmt
            raise _Stop
        return f

    orig_sbell, orig_sell = sbell_cls.from_scipy, sell_mod.sell_from_scipy
    sbell_cls.from_scipy = staticmethod(stop("sbell"))
    sell_mod.sell_from_scipy = stop("sell")
    try:
        with pytest.raises(_Stop):
            fn(A)
    finally:
        sbell_cls.from_scipy = staticmethod(orig_sbell)
        sell_mod.sell_from_scipy = orig_sell
    return route.get("fmt")


def test_auto_large_scattered_route_and_memory():
    """>=10M-nnz scattered matrix: the port's heuristics run without
    densifying (new RSS far below the ~2.6 GB of a 64x BSR blow-up) and
    reach the same terminal constructor as the reference's."""
    n = 2_000_000
    rng = np.random.default_rng(7)
    nnz = 10_000_000
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    A = sps.coo_matrix((np.ones(nnz, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    port_route = _route(auto.auto_format, A, sbell_mod.SBELL, spmv_sell)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert (rss1 - rss0) * 1024 < 600 * 1024 * 1024
    ref_route = _route(ref_auto.auto_format, A, ref_sbell_mod.SBELL,
                       ref_ell_mod)
    assert port_route == ref_route
    assert port_route in ("sbell", "sell")
