"""CG's three vector steps (``ops/cg_vectors.py``) on the CPU: their plain
versions reproduce the plain loop ``solver._cg`` bit for bit, ``cg()``
still matches the reference's ``cg``, and it leaves the caller's b and x0
as they were. The kernels of ``csrc/cg_vectors.cu`` are held against these
plain versions on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops import solver as ref_solver
from libhpc_tpu.sparse.csr import CSR as RefCSR
from libhpc_tpu_torch.ops import cg_vectors, solver, spmv_dia, spmv_sbell
from libhpc_tpu_torch.ops.spmv_dia import DiaPallas
from libhpc_tpu_torch.sparse import DIA
from libhpc_tpu_torch.sparse.csr import CSR
from libhpc_tpu_torch.sparse.sbell import SBELL


def _spd(n=24):
    """The 2-D Poisson matrix on an n x n grid, float32."""
    return matrices.poisson2d(n).astype(np.float32).tocsr()


def _rand(n, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g, dtype=torch.float64).to(dtype)


def _csr_system(dtype=torch.float32):
    A = _spd()
    csr = CSR.from_scipy(A.astype(np.float64) if dtype == torch.float64
                         else A, device="cpu")
    return (lambda v: csr @ v), _rand(A.shape[0], 3, dtype)


def _dia_system():
    A = _spd()
    dp = DiaPallas.from_dia(DIA.from_scipy(A, device="cpu"), T=256,
                            device="cpu")
    return (lambda v: spmv_dia.dia_spmv_pallas(dp, v)), _rand(A.shape[0], 4)


def _pane_system():
    A = _spd(40)
    sb = SBELL.from_scipy(A, device="cpu")
    b = torch.zeros(sb.n_panes * 1024)
    b[:A.shape[0]] = _rand(A.shape[0], 5)
    return ((lambda u: spmv_sbell.sbell_spmv_panes(sb, u)),
            spmv_sbell.x_to_panes(sb, b))


def _widening_system():
    """A float64 operator on float32 vectors: r, p and x turn float64."""
    A = _spd().astype(np.float64)
    csr = CSR.from_scipy(A, device="cpu")
    return (lambda v: csr @ v.to(torch.float64)), _rand(A.shape[0], 6)


SYSTEMS = {"csr": _csr_system, "csr_f64": lambda: _csr_system(torch.float64),
           "dia": _dia_system, "panes": _pane_system,
           "widening": _widening_system}


@pytest.mark.parametrize("x0", [False, True])
@pytest.mark.parametrize("stop", ["iterations", "tolerance"])
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_plain_steps_reproduce_the_plain_loop(name, stop, x0):
    mv, b = SYSTEMS[name]()
    x_start = 0.1 * _rand(b.numel(), 9, b.dtype).reshape(b.shape) \
        if x0 else None
    tol, max_iter = (0.0, 12) if stop == "iterations" else (1e-5, 2000)
    got = solver.cg(mv, b, x_start, tol=tol, max_iter=max_iter)
    want = solver._cg(mv, b, x_start, tol, max_iter, solver._sdot)
    assert got[1] == want[1]
    assert 0 < got[1] < 2000 and (stop == "tolerance" or got[1] == 12)
    assert got[0].dtype == want[0].dtype and got[0].shape == b.shape
    assert torch.equal(got[0], want[0])
    assert got[2].shape == () and torch.equal(got[2], want[2])


def test_each_plain_step_computes_its_formula():
    x, r, p, Ap = (_rand(300, s, torch.float64) for s in range(4))
    x0, r0, p0 = x.clone(), r.clone(), p.clone()
    launches = cg_vectors.CG_VECTOR_LAUNCHES
    ws = cg_vectors.Workspace(r, torch.tensor(2.5, dtype=torch.float64))
    cg_vectors.dot_pAp(p, Ap, ws)
    pq = float(p0 @ Ap)
    assert float(ws.state[cg_vectors.PQ]) == pytest.approx(pq, rel=1e-12)
    cg_vectors.update_xr(x, r, p, Ap, ws)
    alpha = 2.5 / pq
    r1 = r0 - alpha * Ap
    torch.testing.assert_close(x, x0 + alpha * p0, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(r, r1, rtol=1e-12, atol=1e-12)
    rs = float(r1 @ r1)
    assert float(ws.rs) == pytest.approx(rs, rel=1e-12)
    assert float(ws.state[cg_vectors.BETA]) == pytest.approx(rs / 2.5,
                                                            rel=1e-12)
    cg_vectors.update_p(p, r, ws)
    torch.testing.assert_close(p, r1 + (rs / 2.5) * p0, rtol=1e-12,
                               atol=1e-12)
    assert cg_vectors.CG_VECTOR_LAUNCHES == launches   # no kernel here


@pytest.mark.parametrize("x0", [False, True])
def test_cg_matches_the_reference(x0):
    A = _spd(16)
    port, ref = CSR.from_scipy(A, device="cpu"), RefCSR.from_scipy(A)
    b = np.random.default_rng(8).standard_normal(A.shape[0]) \
        .astype(np.float32)
    xs = 0.5 * np.random.default_rng(9).standard_normal(A.shape[0]) \
        .astype(np.float32) if x0 else None
    got = solver.cg(lambda v: port @ v, torch.from_numpy(b),
                    None if xs is None else torch.from_numpy(xs),
                    tol=1e-6, max_iter=2000)
    want = ref_solver.cg(lambda v: ref @ v, jnp.asarray(b),
                         None if xs is None else jnp.asarray(xs),
                         tol=1e-6, max_iter=2000)
    assert abs(got[1] - int(want[1])) <= 1
    assert got[2].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)


def test_cg_leaves_b_and_x0_unchanged():
    mv, b = _csr_system()
    x0 = 0.1 * _rand(b.numel(), 11)
    b_before, x0_before = b.clone(), x0.clone()
    x, it, _ = solver.cg(mv, b, x0, tol=0.0, max_iter=10)
    assert it == 10
    assert torch.equal(b, b_before) and torch.equal(x0, x0_before)
    assert x.data_ptr() not in (b.data_ptr(), x0.data_ptr())


def test_cg_that_runs_no_iteration_returns_x0():
    mv, b = _csr_system()
    x0 = _rand(b.numel(), 12)
    x, it, res2 = solver.cg(mv, torch.zeros_like(b), x0, tol=1e30,
                            max_iter=10)
    assert it == 0 and torch.equal(x, x0)
    assert torch.equal(res2, solver._sdot(mv(x0), mv(x0)))
