"""The port's distributed AMG-PCG (parallel/dist_amg.py) against
libhpc_tpu's on the CPU: the port on a module-scoped pool of 4 gloo ranks,
the reference at 4 shards over 4 of the 8 virtual devices (its SBELL
kernel in Pallas interpret mode), on the same operators and seeded
right-hand sides.

Tolerances: the reference test's own, 2e-3 against scipy's spsolve and
fewer than 40 iterations; the iteration count equal on every rank and
within 2 of the reference's (the packages sum in different orders, so the
loops may cross tol a step apart); the solution within 1e-4 * max|x| of the
reference's (both stop at a relative residual of 1e-6, not at the same
iterate, so the rtol 1e-5 of the matvecs does not apply).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla

import jax

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops import spmv_pallas as ref_spmv_pallas
from libhpc_tpu.parallel import dist_amg as ref_dist_amg
from libhpc_tpu_torch.parallel import dist_amg, programs
from libhpc_tpu_torch.parallel.mesh import RankPool

N = 4


@pytest.fixture(scope="module")
def pool():
    with RankPool(N, "cpu", timeout_s=90) as p:
        yield p


def _fem_spd(n_block_rows=260, seed=17):
    B = matrices.block_random(n_block_rows, block=8, blocks_per_row=5,
                              seed=seed, half_band=4, far_fraction=0.02)
    A = (B + B.T).tocsr()
    rowsum = np.asarray(np.abs(A).sum(axis=1)).ravel()
    return (A + sps.diags(rowsum + 1.0)).tocsr().astype(np.float32)


def _solve_both(pool, A, b):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:N]), ("x",))
    xr, itr, _ = ref_dist_amg.dist_amg_pcg(A, mesh, N, b, tol=1e-6,
                                           max_iter=100)
    outs = pool.run(programs.amg_pcg, A, b, 1e-6, 100, device_type="cpu")
    its = {o[1] for o in outs}
    assert len(its) == 1, its
    it = its.pop()
    assert abs(it - int(itr)) <= 2, (it, int(itr))
    x = np.concatenate([o[0] for o in outs])
    xr = np.asarray(xr)
    np.testing.assert_allclose(x, xr, rtol=0, atol=1e-4 * np.abs(xr).max())
    n = A.shape[0]
    expect = spla.spsolve(A.tocsc().astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(x[:n], expect, rtol=2e-3, atol=2e-3)
    return it


def test_dist_amg_pcg_poisson(pool):
    A = matrices.poisson2d(64)
    b = np.random.default_rng(0).standard_normal(A.shape[0]).astype(
        np.float32)
    assert _solve_both(pool, A, b) < 40


def test_dist_amg_pcg_fem_spd(pool):
    A = _fem_spd()
    b = np.random.default_rng(1).standard_normal(A.shape[0]).astype(
        np.float32)
    _solve_both(pool, A, b)


def test_dist_amg_pcg_chunked_fine_level(pool, monkeypatch):
    """The fine level's shards past the reference's VMEM budget (its cap
    lowered): the reference runs its chunked kernel in the V-cycle; the
    port's matvec reads x whole, has no plan, and gives the same x."""
    from libhpc_tpu.parallel.dist_sbell import DistSBELL as RefDistSBELL

    A = _fem_spd(n_block_rows=1500, seed=23)
    chosen = None
    for cap in (50_000, 44_000, 40_000, 36_000):
        monkeypatch.setattr(ref_spmv_pallas, "VMEM_CAP", cap)
        try:
            cand = RefDistSBELL.from_scipy(A, N)
        except ValueError:
            break
        if cand.offd_chunk is not None and cand.offd_bounds.shape[1] > 1:
            chosen = cap
            break
    assert chosen is not None, "no cap produced a multi-chunk offd plan"
    b = np.random.default_rng(2).standard_normal(A.shape[0]).astype(
        np.float32)
    _solve_both(pool, A, b)


@pytest.mark.parametrize("pre,post", [(0, 0), (2, 1)])
def test_dist_amg_build_refuses_bad_sweeps(pre, post):
    with pytest.raises(ValueError, match="pre"):
        dist_amg.dist_amg_build(matrices.poisson2d(8), None, 1, pre=pre,
                                post=post)
    with pytest.raises(ValueError, match="pre"):
        ref_dist_amg.dist_amg_build(matrices.poisson2d(8), None, 1,
                                    pre=pre, post=post)


def test_dist_amg_build_refuses_a_stalled_coarsening(pool):
    A = matrices.poisson2d(32)
    b = np.ones(A.shape[0], np.float32)
    with pytest.raises(ValueError, match="coarse level has"):
        pool.run(programs.amg_pcg, A, b, device_type="cpu",
                 coarse_hard_max=10)
