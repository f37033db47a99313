"""The port's aggregation AMG (ops/multigrid_sbell.py) against libhpc_tpu's
on the CPU: the same scipy operators and seeded right-hand sides go
through both packages (the reference's SBELL SpMV in Pallas interpret
mode, the port's plain path).

Tolerances: aggregation and every hierarchy level exactly (SBELL arrays,
dinv3, agg, P and P^T), coarse_inv to 1e-6 relative; one V-cycle at rtol
1e-4, atol 1e-5; AMG-PCG against scipy's spsolve at 2e-3 (the reference
test's gate), its iteration count within one of the reference's (the two
packages sum in different orders, so PCG may cross tol a step apart).
The reference hierarchies are built once per module.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops import multigrid_sbell as ref_amg
from libhpc_tpu.ops.spmv_pallas import sbell_spmv as ref_sbell_spmv
from libhpc_tpu_torch.examples.amg_solve import spd_fem
from libhpc_tpu_torch.ops import multigrid_sbell as amg
from libhpc_tpu_torch.ops import solver
from libhpc_tpu_torch.ops.spmv_sbell import sbell_spmv
from libhpc_tpu_torch.sparse.sbell import SBELL

from _torch_port import assert_same_container, port_of
from _torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = {
    # name: (operator, amg_setup keywords)
    "poisson64": (lambda: matrices.poisson2d(64),
                  dict(n_levels=2, coarse_max=1500)),
    "poisson64_sa": (lambda: matrices.poisson2d(64),
                     dict(n_levels=2, coarse_max=1500, smooth_p=True)),
    "poisson64_3lv": (lambda: matrices.poisson2d(64),
                      dict(n_levels=3, coarse_max=200)),
    "fem": (lambda: spd_fem(200), dict(n_levels=3, coarse_max=300)),
}


@pytest.fixture(scope="module")
def systems():
    """{case: (A, reference hierarchy, port hierarchy on the CPU)}."""
    out = {}
    for name, (make, kw) in CASES.items():
        A = make()
        out[name] = (A, ref_amg.amg_setup(A, **kw),
                     amg.amg_setup(A, device="cpu", **kw))
    return out


@pytest.mark.parametrize("name,theta", [("poisson32", 0.08),
                                        ("poisson64", 0.25),
                                        ("fem", 0.25)])
def test_aggregate_matches_reference(name, theta):
    A = {"poisson32": lambda: matrices.poisson2d(32),
         "poisson64": lambda: matrices.poisson2d(64),
         "fem": lambda: spd_fem(200)}[name]()
    agg, nc = amg._aggregate(A, theta)
    ref_agg, ref_nc = ref_amg._aggregate(A, theta)
    assert nc == ref_nc
    assert agg.dtype == ref_agg.dtype
    np.testing.assert_array_equal(agg, ref_agg)
    # the reference test's properties: a partition that coarsens
    assert agg.min() == 0 and agg.max() == nc - 1
    assert np.all(np.bincount(agg) >= 1)
    if name == "poisson32":
        assert nc < A.shape[0] / 2


@pytest.mark.parametrize("name", list(CASES))
def test_setup_matches_reference_level_by_level(systems, name):
    _, ref_H, H = systems[name]
    assert (H.pre, H.post) == (ref_H.pre, ref_H.post)
    assert len(H.levels) == len(ref_H.levels) >= 1
    if name == "poisson64_3lv":
        assert len(H.levels) == 2
    for lev, ref_lev in zip(H.levels, ref_H.levels):
        assert_same_container(lev, ref_lev)      # sbell, dinv3, agg, P, P^T
        assert lev.agg.dtype == torch.int32
        assert (lev.p_csr is None) == (name != "poisson64_sa")
    ref_inv = np.asarray(ref_H.coarse_inv)
    got = H.coarse_inv.numpy()
    assert got.dtype == np.float32 and got.shape == ref_inv.shape
    np.testing.assert_allclose(got, ref_inv, rtol=1e-6,
                               atol=1e-6 * np.abs(ref_inv).max())


@pytest.mark.parametrize("name", list(CASES))
def test_hierarchy_carried_from_reference_leaves(systems, name):
    """port_of builds an AMGHierarchy from the reference's numpy leaves;
    to_numpy and to() reach into the tuple of levels and P / P^T."""
    _, ref_H, H = systems[name]
    carried = port_of(ref_H)
    for lev, ref_lev in zip(carried.levels, ref_H.levels):
        assert_same_container(lev, ref_lev)
    np.testing.assert_array_equal(carried.coarse_inv.numpy(),
                                  np.asarray(ref_H.coarse_inv))
    tree = H.to("cpu").to_numpy()
    assert isinstance(tree["levels"], tuple)
    for lev, got in zip(H.levels, tree["levels"]):
        np.testing.assert_array_equal(got["dinv3"], lev.dinv3.numpy())
        np.testing.assert_array_equal(got["sbell"]["vflat"],
                                      lev.sbell.vflat.numpy())
        if lev.p_csr is None:
            assert got["p_csr"] is None and got["pt_csr"] is None
        else:
            np.testing.assert_array_equal(got["pt_csr"]["data"],
                                          lev.pt_csr.data.numpy())
    np.testing.assert_array_equal(tree["coarse_inv"], H.coarse_inv.numpy())


@pytest.mark.parametrize("name,seed", [("poisson64_sa", 4),
                                       ("poisson64_3lv", 7), ("fem", 5)])
def test_vcycle_matches_reference(systems, name, seed):
    A, ref_H, H = systems[name]
    b = np.random.default_rng(seed).standard_normal(A.shape[0]) \
        .astype(np.float32)
    want = np.asarray(ref_amg.amg_vcycle(ref_H, jnp.asarray(b)))
    got = amg.amg_vcycle(H, torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (A.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # a numpy b goes to the hierarchy's device
    np.testing.assert_array_equal(amg.amg_vcycle(H, b).numpy(),
                                  got.numpy())


def test_vcycle_contracts_poisson(systems):
    """The reference test's property: one V-cycle of the two-level
    Poisson hierarchy contracts the residual below 0.8 |b|."""
    A, _, H = systems["poisson64"]
    b = np.random.default_rng(0).standard_normal(A.shape[0]) \
        .astype(np.float32)
    r1 = b - A @ amg.amg_vcycle(H, torch.from_numpy(b)).numpy()
    assert np.linalg.norm(r1) < 0.8 * np.linalg.norm(b)


@pytest.mark.parametrize("name,seed,max_iter,against_reference", [
    ("poisson64", 1, 100, True), ("fem", 2, 200, False)])
def test_pcg_matches_reference_and_direct(systems, name, seed, max_iter,
                                          against_reference):
    """Against spsolve on both systems; the reference's iteration count
    (one interpret-mode PCG, the costly part) on the Poisson one."""
    A, ref_H, H = systems[name]
    b = np.random.default_rng(seed).standard_normal(A.shape[0]) \
        .astype(np.float32)
    sb = H.levels[0].sbell
    x, it, res2 = amg.amg_pcg(H, lambda v: sbell_spmv(sb, v),
                              torch.from_numpy(b), tol=1e-6,
                              max_iter=max_iter)
    assert isinstance(it, int)
    if against_reference:
        ref_sb = ref_H.levels[0].sbell
        _, ref_it, _ = ref_amg.amg_pcg(
            ref_H, lambda v: ref_sbell_spmv(ref_sb, v), jnp.asarray(b),
            tol=1e-6, max_iter=max_iter)
        assert abs(it - int(ref_it)) <= 1
    assert res2.shape == () and res2.dtype == torch.float32
    expect = spla.spsolve(A.tocsc().astype(np.float64),
                          b.astype(np.float64))
    np.testing.assert_allclose(x.numpy(), expect, rtol=2e-3, atol=2e-3)
    if name == "poisson64":
        _, it_cg, _ = solver.cg(lambda v: sbell_spmv(sb, v),
                                torch.from_numpy(b), tol=1e-6,
                                max_iter=1000)
        assert it < it_cg / 2


def test_smoothed_aggregation_takes_fewer_iterations(systems):
    A, _, H0 = systems["poisson64"]
    H1 = systems["poisson64_sa"][2]
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.shape[0]).astype(np.float32))
    sb = H0.levels[0].sbell
    _, it0, _ = amg.amg_pcg(H0, lambda v: sbell_spmv(sb, v), b, tol=1e-6,
                            max_iter=100)
    x1, it1, _ = amg.amg_pcg(H1, lambda v: sbell_spmv(sb, v), b, tol=1e-6,
                             max_iter=100)
    expect = spla.spsolve(A.tocsc().astype(np.float64),
                          b.numpy().astype(np.float64))
    np.testing.assert_allclose(x1.numpy(), expect, rtol=2e-3, atol=2e-3)
    assert it1 < it0


def test_setup_rejects_what_the_reference_rejects():
    A = matrices.poisson2d(32)
    for kw, msg in ((dict(pre=0, post=0), "must be >= 1"),
                    (dict(pre=1, post=2), "non-symmetric")):
        with pytest.raises(ValueError, match=msg):
            ref_amg.amg_setup(A, n_levels=2, **kw)
        with pytest.raises(ValueError, match=msg):
            amg.amg_setup(A, n_levels=2, device="cpu", **kw)
    rect = sps.random(40, 30, density=0.2, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(0))
    with pytest.raises(ValueError, match="square"):
        amg.amg_setup(rect, device="cpu")
    with pytest.raises(ValueError, match="coarsest level has"):
        amg.amg_setup(A, n_levels=1, coarse_hard_max=500, device="cpu")


def test_coarse_only_hierarchy_is_a_direct_solve():
    """An operator under coarse_max has no level: the V-cycle is the dense
    inverse, as in the reference."""
    A = spd_fem(40)
    ref_H = ref_amg.amg_setup(A)
    H = amg.amg_setup(A, device="cpu")
    assert H.levels == () and ref_H.levels == ()
    b = np.random.default_rng(6).standard_normal(A.shape[0]) \
        .astype(np.float32)
    want = np.asarray(ref_amg.amg_vcycle(ref_H, jnp.asarray(b)))
    got = amg.amg_vcycle(H, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    sb = SBELL.from_scipy(A, device="cpu")
    x, it, _ = amg.amg_pcg(H, lambda v: sbell_spmv(sb, v),
                           torch.from_numpy(b))
    assert it <= 2
    np.testing.assert_allclose(
        x.numpy(), spla.spsolve(A.tocsc().astype(np.float64),
                                b.astype(np.float64)), rtol=2e-3, atol=2e-3)


def test_cpu_hierarchy_takes_the_plain_path(systems, monkeypatch):
    """On CPU tensors every sweep runs the plain SpMV: the kernel launch
    counters stay at 0, and the kernel entry point is never reached."""
    from libhpc_tpu_torch.ops import _cuda_utils, far_sbell, spmv_sbell

    def no_kernel(*_):
        raise AssertionError("a CPU tensor reached a kernel entry point")

    monkeypatch.setattr(spmv_sbell, "kernel_fn", no_kernel)
    monkeypatch.setattr(_cuda_utils, "kernel_fn", no_kernel)
    for mod, name in ((spmv_sbell, "SPMV_LAUNCHES"),
                      (spmv_sbell, "NEAR_LAUNCHES"),
                      (far_sbell, "FAR_LAUNCHES")):
        monkeypatch.setattr(mod, name, 0)
    A, _, H = systems["poisson64_3lv"]
    u = amg.amg_vcycle(H, np.ones(A.shape[0], np.float32))
    assert u.device.type == "cpu" and bool(torch.isfinite(u).all())
    assert (spmv_sbell.SPMV_LAUNCHES, spmv_sbell.NEAR_LAUNCHES,
            far_sbell.FAR_LAUNCHES) == (0, 0, 0)
