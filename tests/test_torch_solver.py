"""The port's CSR, csr_spmv and Krylov solvers against libhpc_tpu (CPU),
and the main path as a whole: CG in SBELL pane layout.

Solver parity allows the iteration counts to differ by one and compares x
at rtol 1e-4: the two packages take their sums in different orders, so CG
can cross `tol` one step apart.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops import solver as ref_solver
from libhpc_tpu.ops import spmv as ref_spmv
from libhpc_tpu.ops import spmv_pallas as ref_sbell_spmv
from libhpc_tpu.sparse.csr import CSR as RefCSR
from libhpc_tpu.sparse.sbell import SBELL as RefSBELL
from libhpc_tpu_torch.ops import solver, spmv, spmv_sbell
from libhpc_tpu_torch.sparse.csr import CSR
from libhpc_tpu_torch.sparse.sbell import SBELL

from _torch_port import assert_same_container, port_of


@pytest.mark.parametrize("name", ["poisson", "random_rect"])
def test_csr_parity(name):
    if name == "poisson":
        A = matrices.poisson2d(16)
    else:
        A = sps.random(60, 80, density=0.1, format="csr", dtype=np.float32,
                       random_state=np.random.RandomState(19))
    ref = RefCSR.from_scipy(A)
    port = CSR.from_scipy(A, device="cpu")
    assert_same_container(port, ref)
    assert_same_container(port_of(ref), ref)
    assert port.nnz == ref.nnz and port.dtype == torch.float32
    assert np.array_equal(port.row_of_nnz().numpy(),
                          np.asarray(ref.row_of_nnz()))
    assert np.array_equal(port.row_lengths().numpy(),
                          np.asarray(ref.row_lengths()))
    assert port.max_row_length() == ref.max_row_length()
    np.testing.assert_array_equal(port.todense().numpy(), A.toarray())
    assert (port.to_scipy() != A).nnz == 0
    assert_same_container(CSR.from_dense(A.toarray(), device="cpu"), ref)

    x = np.random.default_rng(0).standard_normal(A.shape[1]) \
        .astype(np.float32)
    y = (port @ torch.from_numpy(x)).numpy()
    assert y.dtype == np.float32 and y.shape == (A.shape[0],)
    np.testing.assert_allclose(y, A @ x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        y, np.asarray(ref_spmv.csr_spmv(ref, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(spmv.csr_spmv(port, torch.from_numpy(x))
                                  .numpy(), y)


def _poisson_system(n=16, seed=0):
    A = matrices.poisson2d(n)
    x_true = np.random.default_rng(seed).random(A.shape[0]) \
        .astype(np.float32)
    return A, (A @ x_true).astype(np.float32)


def _assert_solves_alike(port_out, ref_out):
    x, it, res = port_out
    rx, rit, rres = ref_out
    assert isinstance(it, int)
    assert abs(it - int(rit)) <= 1
    assert res.shape == () and res.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("method", ["cg", "pcg", "bicgstab"])
def test_krylov_parity(method):
    A, b = _poisson_system()
    if method == "bicgstab":
        # convective bias on the shifted Poisson (A + I/2): nonsymmetric
        # and well conditioned, so f32 round-off cannot drift the two
        # packages' BiCGSTAB runs many steps apart
        n = A.shape[0]
        A = (A + sps.diags(np.full(n - 1, -0.3, np.float32), 1)
             + 0.5 * sps.eye(n)).tocsr().astype(np.float32)
    port, ref = CSR.from_scipy(A, device="cpu"), RefCSR.from_scipy(A)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    kw = dict(tol=1e-6, max_iter=2000)
    if method == "pcg":
        d = A.diagonal().astype(np.float32)
        got = solver.pcg(lambda v: port @ v, torch.from_numpy(d), bt, **kw)
        want = ref_solver.pcg(lambda v: ref @ v, jnp.asarray(d), bj, **kw)
    else:
        got = getattr(solver, method)(lambda v: port @ v, bt, **kw)
        want = getattr(ref_solver, method)(lambda v: ref @ v, bj, **kw)
    _assert_solves_alike(got, want)
    assert got[1] < 2000
    r = b.astype(np.float64) - A @ got[0].numpy().astype(np.float64)
    assert np.linalg.norm(r) <= 1e-5 * np.linalg.norm(b)


def test_jacobi_parity():
    A, b = _poisson_system(n=8, seed=2)
    port, ref = CSR.from_scipy(A, device="cpu"), RefCSR.from_scipy(A)
    d = A.diagonal().astype(np.float32)
    x = solver.jacobi(lambda v: port @ v, torch.from_numpy(d),
                      torch.from_numpy(b), n_iter=200, omega=0.8)
    rx = ref_solver.jacobi(lambda v: ref @ v, jnp.asarray(d), jnp.asarray(b),
                           n_iter=200, omega=0.8)
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=1e-4,
                               atol=1e-5)


def test_blas1():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((2, 300)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(solver.dot(ta, tb)),
                               float(ref_solver.dot(a, b)), rtol=1e-5)
    np.testing.assert_allclose(float(solver.norm2(ta)),
                               float(ref_solver.norm2(a)), rtol=1e-6)
    np.testing.assert_allclose(solver.axpy(2.0, ta, tb).numpy(),
                               np.asarray(ref_solver.axpy(2.0, a, b)),
                               rtol=1e-6)


def _spd_block_system():
    """A small SPD SBELL system, built as __graft_entry__.py:128-133
    builds its AMG system: symmetrize, then diag(|A| rowsum + 1)."""
    Au = matrices.block_random(260, block=8, blocks_per_row=5, seed=13,
                               half_band=5, far_fraction=0.04)
    As = Au + Au.T
    rowsum = np.asarray(np.abs(As).sum(axis=1)).ravel()
    return (As + sps.diags(rowsum + 1.0)).tocsr().astype(np.float32)


def test_cg_sbell_panes_main_path():
    """The slice as a whole: scipy -> SBELL -> SpMV in pane layout -> CG,
    through both packages on the same SPD system."""
    A = _spd_block_system()
    n = A.shape[0]
    ref = RefSBELL.from_scipy(A)
    port = SBELL.from_scipy(A, device="cpu")
    assert_same_container(port, ref)
    b = np.ones(port.n_panes * 1024, np.float32)
    b[n:] = 0.0
    b3 = spmv_sbell.x_to_panes(port, torch.from_numpy(b))
    x3, it, res = solver.cg(lambda u: spmv_sbell.sbell_spmv_panes(port, u),
                            b3, tol=1e-5)
    rb3 = ref_sbell_spmv.x_to_panes(ref, jnp.asarray(b))
    rx3, rit, _ = ref_solver.cg(
        lambda u: ref_sbell_spmv.sbell_spmv_panes(ref, u), rb3, tol=1e-5)
    assert 0 < it < 1000 and abs(it - int(rit)) <= 1
    x = spmv_sbell.panes_to_x(port, x3).numpy()[:n]
    rx = np.asarray(ref_sbell_spmv.panes_to_x(ref, rx3))[:n]
    assert np.all(np.isfinite(x))
    np.testing.assert_allclose(x, rx, rtol=1e-3, atol=1e-6)
    for sol in (x, rx):
        r = b[:n].astype(np.float64) - A @ sol.astype(np.float64)
        assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b[:n])
