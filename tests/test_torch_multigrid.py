"""The port's geometric multigrid (ops/multigrid.py) against libhpc_tpu's
on the CPU, and against the oracles of the reference's
tests/test_multigrid.py at that test's bounds.

Transfers and operators of both hierarchies match the reference at rtol
1e-6 (atol 1e-6 of the largest entry); mg_solve / mg_solve_cc match a
direct solve at 2e-3 / 5e-3 and the reference's solve at 1e-4 (both take
the same steps in float32, in a different order of adds).
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

from libhpc_tpu.bench.matrices import poisson2d
from libhpc_tpu.ops import multigrid as ref_mg
from libhpc_tpu_torch.ops import multigrid as mg

from _torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("n", [7, 15, 31])
def test_vertex_transfers_and_operator_match_reference(rng, n):
    h = 1.0 / (n + 1)
    u = rng.random((n, n)).astype(np.float32)
    _close(mg.poisson_op(_t(u), h), ref_mg.poisson_op(jnp.asarray(u), h))
    rc = mg.restrict_fw(_t(u))
    assert rc.shape == ((n - 1) // 2,) * 2
    _close(rc, ref_mg.restrict_fw(jnp.asarray(u)))
    e = mg.prolong_bilinear(rc)
    assert e.shape == (n, n)
    _close(e, ref_mg.prolong_bilinear(jnp.asarray(rc.numpy())))
    f = rng.random((n, n)).astype(np.float32)
    _close(mg.smooth_jacobi(_t(u), _t(f), h, 3),
           ref_mg.smooth_jacobi(jnp.asarray(u), jnp.asarray(f), h, 3),
           rtol=1e-5)


@pytest.mark.parametrize("m", [1, 4, 8])
def test_cell_transfers_and_operator_match_reference(rng, m):
    n = 2 * m
    h = 1.0 / n
    u = rng.random((n, n)).astype(np.float32)
    _close(mg.poisson_op_cc(_t(u), h),
           ref_mg.poisson_op_cc(jnp.asarray(u), h))
    _close(mg._diag_cc(n, h, torch.float32),
           ref_mg._diag_cc(n, h, jnp.float32))
    _close(mg.restrict_cc(_t(u)), ref_mg.restrict_cc(jnp.asarray(u)))
    e = rng.random((m, m)).astype(np.float32)
    _close(mg.prolong_cc(_t(e)), ref_mg.prolong_cc(jnp.asarray(e)))
    f = rng.random((n, n)).astype(np.float32)
    _close(mg.smooth_jacobi_cc(_t(u), _t(f), h, 3),
           ref_mg.smooth_jacobi_cc(jnp.asarray(u), jnp.asarray(f), h, 3),
           rtol=1e-5)


def test_operator_matches_matrix(rng):
    n = 31
    h = 1.0 / (n + 1)
    A = poisson2d(n) / (h * h)
    u = rng.random((n, n)).astype(np.float32)
    got = mg.poisson_op(_t(u), h).numpy()
    np.testing.assert_allclose(got, (A @ u.ravel()).reshape(n, n),
                               rtol=1e-4, atol=1e-2)


def test_prolong_of_smooth_is_accurate():
    m = 7
    xs = np.arange(1, m + 1) / (m + 1)
    f = np.add.outer(xs, 2 * xs).astype(np.float32)
    e = mg.prolong_bilinear(_t(f)).numpy()
    n = 2 * m + 1
    xf = np.arange(1, n + 1) / (n + 1)
    expect = np.add.outer(xf, 2 * xf).astype(np.float32)
    np.testing.assert_allclose(e[2:-2, 2:-2], expect[2:-2, 2:-2], atol=1e-5)


def test_vcycle_contracts_and_matches_reference(rng):
    n = 63
    h = 1.0 / (n + 1)
    f = rng.random((n, n)).astype(np.float32)
    u1, r1 = mg.mg_solve(_t(f), h=h, n_cycles=1)
    u2, r2 = mg.mg_solve(_t(f), h=h, n_cycles=2)
    assert r2.shape == () and r2.dtype == torch.float32
    assert float(r2) < 0.35 * float(r1)
    ru2, rr2 = ref_mg.mg_solve(jnp.asarray(f), h=h, n_cycles=2)
    np.testing.assert_allclose(u2.numpy(), np.asarray(ru2), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(ru2)).max())
    np.testing.assert_allclose(float(r2), float(rr2), rtol=1e-2)


def test_mg_matches_direct_solve(rng):
    n = 63
    h = 1.0 / (n + 1)
    f = rng.random((n, n)).astype(np.float32)
    A = (poisson2d(n) / (h * h)).tocsc()
    expect = spla.spsolve(A.astype(np.float64),
                          f.ravel().astype(np.float64)).reshape(n, n)
    u, res = mg.mg_solve(f, h=h, n_cycles=12, device="cpu")
    np.testing.assert_allclose(u.numpy(), expect, rtol=2e-3, atol=2e-3)
    ru, _ = ref_mg.mg_solve(jnp.asarray(f), h=h, n_cycles=12)
    np.testing.assert_allclose(u.numpy(), np.asarray(ru), rtol=1e-4,
                               atol=1e-4 * np.abs(expect).max())


def test_mg_beats_cg_in_work(rng):
    from libhpc_tpu_torch.ops import solver
    from libhpc_tpu_torch.sparse import DIA

    n = 63
    h = 1.0 / (n + 1)
    f = rng.random((n, n)).astype(np.float32)
    _, res = mg.mg_solve(_t(f), h=h, n_cycles=8)
    assert float(res) / float(np.linalg.norm(f)) < 1e-4
    dia = DIA.from_scipy(poisson2d(n) / (h * h), device="cpu")
    _, it_cg, _ = solver.cg(lambda v: dia @ v, _t(f.ravel()), tol=1e-4,
                            max_iter=1000)
    assert 8 * 4 < it_cg


def test_cc_transfer_adjoint(rng):
    """restrict_cc == (1/4) prolong_cc^T (the discrete adjoint)."""
    m = 8
    u = rng.random((m, m)).astype(np.float32)
    v = rng.random((2 * m, 2 * m)).astype(np.float32)
    lhs = float(torch.sum(mg.prolong_cc(_t(u)) * _t(v)))
    rhs = 4.0 * float(torch.sum(_t(u) * mg.restrict_cc(_t(v))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4)


def test_cc_vcycle_contracts_and_matches_reference(rng):
    n = 64
    h = 1.0 / n
    f = rng.random((n, n)).astype(np.float32)
    _, r1 = mg.mg_solve_cc(_t(f), h=h, n_cycles=1)
    u2, r2 = mg.mg_solve_cc(_t(f), h=h, n_cycles=2)
    assert float(r2) < 0.4 * float(r1)
    ru2, rr2 = ref_mg.mg_solve_cc(jnp.asarray(f), h=h, n_cycles=2)
    np.testing.assert_allclose(u2.numpy(), np.asarray(ru2), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(ru2)).max())
    np.testing.assert_allclose(float(r2), float(rr2), rtol=1e-2)


def test_cc_matches_direct(rng):
    """Oracle: the dense matrix of the same reflective-ghost operator
    (applied to identity columns), solved in float64."""
    n = 16
    h = 1.0 / n
    f = rng.random((n, n)).astype(np.float32)
    eye = torch.eye(n * n).reshape(n * n, n, n)
    cols = torch.stack([mg.poisson_op_cc(e, h).reshape(-1) for e in eye])
    A = cols.numpy().T.astype(np.float64)
    expect = np.linalg.solve(A, f.ravel().astype(np.float64)).reshape(n, n)
    u, _ = mg.mg_solve_cc(_t(f), h=h, n_cycles=12)
    np.testing.assert_allclose(u.numpy(), expect, rtol=5e-3, atol=5e-3)
    ru, _ = ref_mg.mg_solve_cc(jnp.asarray(f), h=h, n_cycles=12)
    np.testing.assert_allclose(u.numpy(), np.asarray(ru), rtol=1e-4,
                               atol=1e-4 * np.abs(expect).max())


def test_examples_run_on_the_cpu():
    """The port's examples, at small sizes with device="cpu"."""
    from libhpc_tpu_torch.examples import amg_solve, multigrid_demo
    from libhpc_tpu_torch.examples import poisson_cg

    out = multigrid_demo.main(5, device="cpu")
    assert out["mg_residual"] < 1e-3 and out["cg_iterations"] > 32
    out = poisson_cg.main(20, device="cpu")
    assert out["max_err"] < 1e-3 and out["pcg_iterations"] >= 1
    out = amg_solve.main(500, device="cpu")
    assert out["rel_res"] < 1e-5
    assert out["iterations"] < out["cg_iterations"]
