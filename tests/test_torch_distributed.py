"""The port's distributed layer (libhpc_tpu_torch/parallel/) against
libhpc_tpu's on the CPU.

The port runs in a module-scoped pool of 4 gloo ranks (spawned
processes); each test sends one of ``parallel/programs.py``'s programs to
every rank and joins the ranks' shards. The reference runs in this
process, through ``jax.shard_map`` over 4 of the 8 virtual CPU devices, on
the same inputs (numpy seeds) and at the same shard count.

Tolerances: the port against the reference at rtol 1e-5, atol 1e-6 *
max|y| (exactly for the halo exchanges, the containers and the integer
Poisson stencils' layouts); against the reference test's own oracle at
that test's tolerance (1e-4 for the SpMVs and stencils, 1e-3 for the
blurs and SpMM, 1e-2 for the CG solutions); the CG iteration counts within
2 of the reference's and equal on every rank. The containers equal the
reference's array by array at 1, 4 and 8 shards (no ranks needed).
"""

import operator
import os
import time

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libhpc_tpu.parallel import dist2d as ref_dist2d
from libhpc_tpu.parallel import dist_dia as ref_dist_dia
from libhpc_tpu.parallel import dist_spmv as ref_dist_spmv
from libhpc_tpu.parallel import dist_stencil as ref_dist_stencil
from libhpc_tpu.parallel import halo as ref_halo
from libhpc_tpu_torch.bench import matrices
from libhpc_tpu_torch.parallel import programs
from libhpc_tpu_torch.parallel.dist2d import Dist2DCSR
from libhpc_tpu_torch.parallel.dist_dia import DistDIA
from libhpc_tpu_torch.parallel.dist_spmv import DistCSR
from libhpc_tpu_torch.parallel.mesh import RankError, RankPool

from _torch_port import assert_same_container
from test_stencil import naive_blur_x, naive_blur_y

N = 4          # ranks, and the reference's shard count
CPU = dict(device_type="cpu")


@pytest.fixture(scope="module")
def pool():
    with RankPool(N, "cpu", timeout_s=90) as p:
        yield p


def ref_mesh_1d():
    return Mesh(np.array(jax.devices()[:N]), ("x",))


def ref_mesh_2d(grid):
    pr, pc = grid
    return Mesh(np.array(jax.devices()[:pr * pc]).reshape(pr, pc),
                ("py", "px"))


def ref_shard_map(body, x, mesh, spec=P("x")):
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=spec,
                              out_specs=spec))
    return np.asarray(f(jax.device_put(jnp.asarray(x),
                                       NamedSharding(mesh, spec))))


def put(x, mesh, spec=P("x")):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def close_to_ref(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * max(np.abs(ref).max(), 1e-30))


def joined(outs):
    return np.concatenate(outs)


def padded_random(n, seed=17):
    return sps.random(n, n, density=0.05, format="csr", dtype=np.float32,
                      random_state=np.random.RandomState(seed))


def tridiag(n):
    return sps.diags([np.full(n - 1, -1.0), np.full(n, 2.0),
                      np.full(n - 1, -1.0)], [-1, 0, 1]
                     ).tocsr().astype(np.float32)


# --- containers --------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("name", ["poisson16", "random101", "tridiag101"])
def test_dist_containers_equal_reference(name, n_shards):
    A = {"poisson16": lambda: matrices.poisson2d(16),
         "random101": lambda: padded_random(101),
         "tridiag101": lambda: tridiag(101)}[name]()
    assert_same_container(DistCSR.from_scipy(A, n_shards),
                          ref_dist_spmv.DistCSR.from_scipy(A, n_shards))
    if name != "random101":    # a random matrix's band passes a shard
        assert_same_container(DistDIA.from_scipy(A, n_shards),
                              ref_dist_dia.DistDIA.from_scipy(A, n_shards))


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (2, 4), (4, 1)])
@pytest.mark.parametrize("name", ["poisson16", "random101"])
def test_dist2d_container_equals_reference(name, grid):
    A = matrices.poisson2d(16) if name == "poisson16" else padded_random(101)
    assert_same_container(Dist2DCSR.from_scipy(A, grid),
                          ref_dist2d.Dist2DCSR.from_scipy(A, grid))


def test_dist_dia_bandwidth_guard():
    DistDIA.from_scipy(matrices.poisson2d(64), 8)
    with pytest.raises(ValueError, match="bandwidth"):
        DistDIA.from_scipy(matrices.poisson2d(8), 32)
    with pytest.raises(ValueError, match="square"):
        DistCSR.from_scipy(sps.random(4, 6, format="csr"), 2)


# --- the launcher ------------------------------------------------------------


def test_launcher_reraises_a_rank_exception():
    with RankPool(2, "cpu", timeout_s=30) as p:
        assert p.run(operator.add, 2, 3) == [5, 5]
        with pytest.raises(ZeroDivisionError) as e:
            p.run(operator.truediv, 1, 0)
        assert "raised in rank" in "".join(e.value.__notes__)
        assert not p._procs               # every rank stopped
        assert p.run(operator.mul, 2, 3) == [6, 6]   # new ranks


def test_launcher_bounds_every_wait():
    with RankPool(2, "cpu", timeout_s=3) as p:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            p.run(time.sleep, 60)
        assert time.monotonic() - t0 < 20
        with pytest.raises(RankError, match="exited"):
            p.run(os._exit, 3)
        assert not p._procs


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where no card is present")
def test_cuda_without_a_card_raises():
    from libhpc_tpu_torch.dryrun import dryrun_multichip
    from libhpc_tpu_torch.parallel.mesh import launch, make_mesh_1d

    with pytest.raises(RuntimeError, match="NVIDIA"):
        make_mesh_1d()
    with pytest.raises(RuntimeError, match="NVIDIA"):
        make_mesh_1d(1, device_type="cuda")
    with pytest.raises(RuntimeError, match="NVIDIA"):
        dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="NVIDIA"):
        launch(2, operator.add, (1, 2), device_type="cuda")
    with pytest.raises(RuntimeError, match="NVIDIA"):
        launch(2, operator.add, (1, 2))            # the card by default
    with pytest.raises(RuntimeError, match="NVIDIA"):
        RankPool(2)
    import torch.distributed as dist
    assert not dist.is_initialized()


# --- collectives and halo exchange ----------------------------------------


@pytest.mark.parametrize("wrap", [False, True])
def test_collectives(pool, rng, wrap):
    """Each collective against the reference's inside shard_map (exactly;
    the sums at rtol 1e-6), and shift_up / shift_down against their
    definition (zeros at the open ends)."""
    from libhpc_tpu.parallel import collectives as rc

    x = rng.random((32, 8)).astype(np.float32)      # 8 rows a rank
    outs = pool.run(programs.collectives, x, wrap, **CPU)
    mesh = ref_mesh_1d()
    xs = x.reshape(N, 8, 8)
    ref = {
        "all_reduce_sum": lambda s: rc.all_reduce_sum(s, "x"),
        "shift_up": lambda s: rc.shift_up(s, "x", wrap),
        "shift_down": lambda s: rc.shift_down(s, "x", wrap),
        "reduce_scatter": lambda s: rc.reduce_scatter(s, "x"),
    }
    for name, body in ref.items():
        want = ref_shard_map(body, x, mesh)
        got = joined([o[name] for o in outs])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    for s, o in enumerate(outs):
        assert o["my_index"] == s
        np.testing.assert_array_equal(o["all_gather"], x)
        np.testing.assert_array_equal(o["all_gather_stacked"], xs)
        up = xs[s - 1] if s > 0 or wrap else np.zeros_like(xs[0])
        down = xs[(s + 1) % N] if s < N - 1 or wrap else np.zeros_like(xs[0])
        np.testing.assert_array_equal(o["shift_up"], up)
        np.testing.assert_array_equal(o["shift_down"], down)
        np.testing.assert_allclose(o["all_reduce_sum"], xs.sum(0),
                                   rtol=1e-6)
        np.testing.assert_allclose(o["reduce_scatter"],
                                   xs.sum(0)[2 * s:2 * s + 2], rtol=1e-6)


# --- halo exchange ----------------------------------------------------------


@pytest.mark.parametrize("wrap", [False, True])
def test_halo_exchange(pool, wrap):
    m, n = 64, 128                       # 16 rows a shard
    x = np.arange(m * n, dtype=np.float32).reshape(m, n)
    outs = pool.run(programs.halo_exchange, x, 2, wrap, **CPU)

    def body(shard):
        top, bot = ref_halo.exchange_halo_1d(shard, 2, "x", wrap)
        return jnp.concatenate([top, bot], axis=0)

    ref = ref_shard_map(body, x, ref_mesh_1d()).reshape(N, 4, n)
    xn = x.reshape(N, 16, n)
    for s, (top, bot) in enumerate(outs):
        np.testing.assert_array_equal(top, ref[s, :2])
        np.testing.assert_array_equal(bot, ref[s, 2:])
        top_expect = xn[s - 1, -2:] if s > 0 or wrap else np.zeros((2, n))
        bot_expect = (xn[(s + 1) % N, :2] if s < N - 1 or wrap
                      else np.zeros((2, n)))
        np.testing.assert_array_equal(top, top_expect)
        np.testing.assert_array_equal(bot, bot_expect)


def _ref_three_point(h):
    def stencil(p):
        m = p.shape[0] - 2 * h
        return p[:m] + 2.0 * p[h:h + m] + 3.0 * p[2 * h:2 * h + m]

    return stencil


@pytest.mark.parametrize("halo,wrap", [(2, False), (2, True), (5, False)])
def test_halo_stencil_overlapped(pool, rng, halo, wrap):
    """16 rows a shard: h = 2 splits interior / boundary, h = 5 (m < 4h)
    takes the exchange-then-compute path."""
    x = rng.random((64, 24)).astype(np.float32)
    outs = pool.run(programs.halo_stencil, x, halo, wrap, **CPU)
    st = _ref_three_point(halo)
    ref = ref_shard_map(
        lambda s: ref_halo.halo_stencil_overlapped(s, st, halo, "x", wrap),
        x, ref_mesh_1d())
    ref_h = ref_shard_map(
        lambda s: st(ref_halo.exchange_to_halo(s, halo, "x", wrap).data),
        x, ref_mesh_1d())
    close_to_ref(joined([o[0] for o in outs]), ref)
    close_to_ref(joined([o[1] for o in outs]), ref_h)
    # the oracle: the stencil on the whole array, zero (or wrapped) ends
    xp = np.concatenate([x[-halo:], x, x[:halo]]) if wrap else np.pad(
        x, ((halo, halo), (0, 0)))
    np.testing.assert_allclose(joined([o[0] for o in outs]),
                               np.asarray(st(xp)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("wrap", [False, True])
def test_pad_with_halo_2d(pool, rng, wrap):
    grid = (2, 2)
    x = rng.random((16, 32)).astype(np.float32)
    outs = pool.run(programs.pad_2d, x, 1, grid, wrap, **CPU)
    mesh = ref_mesh_2d(grid)
    spec = P("py", "px")
    f = jax.jit(jax.shard_map(
        lambda s: ref_halo.pad_with_halo_2d(s, 1, ("py", "px"), wrap),
        mesh=mesh, in_specs=spec, out_specs=spec))
    ref = np.asarray(f(put(x, mesh, spec)))       # (2 * 10, 2 * 18)
    for r, got in enumerate(outs):
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(got, ref[i * 10:(i + 1) * 10,
                                               j * 18:(j + 1) * 18])


# --- stencils -----------------------------------------------------------------


@pytest.mark.parametrize("shape,r,overlap", [((128, 256), 2, False),
                                             ((128, 256), 2, True),
                                             ((512, 256), 8, True)])
def test_dist_blur2d(pool, rng, shape, r, overlap):
    a = rng.random(shape).astype(np.float32)
    got = joined(pool.run(programs.blur2d, a, r, overlap, **CPU))
    mesh = ref_mesh_1d()
    ref = np.asarray(ref_dist_stencil.dist_blur2d_fn(
        mesh, radius=r, overlap=overlap)(put(a, mesh)))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(got, naive_blur_y(naive_blur_x(a, r), r),
                               rtol=1e-3, atol=1e-3)


def test_dist_poisson(pool, rng):
    from libhpc_tpu.ops.stencil import poisson5_apply

    u = rng.random((64, 64)).astype(np.float32)
    got = joined(pool.run(programs.poisson, u, **CPU))
    mesh = ref_mesh_1d()
    close_to_ref(got, ref_dist_stencil.dist_poisson_fn(mesh)(put(u, mesh)))
    np.testing.assert_allclose(got, np.asarray(poisson5_apply(
        jnp.asarray(u))), rtol=1e-4, atol=1e-4)


def test_dist_poisson3d(pool, rng):
    from libhpc_tpu.ops.stencil import poisson7_apply

    u = rng.random((32, 16, 16)).astype(np.float32)
    got = joined(pool.run(programs.poisson3d, u, **CPU))
    mesh = ref_mesh_1d()
    close_to_ref(got, ref_dist_stencil.dist_poisson3d_fn(mesh)(put(u, mesh)))
    np.testing.assert_allclose(got, np.asarray(poisson7_apply(
        jnp.asarray(u))), rtol=1e-4, atol=1e-4)


def test_dist_poisson_2dmesh(pool, rng):
    from libhpc_tpu.ops.stencil import poisson5_apply

    grid = (2, 2)
    u = rng.random((32, 64)).astype(np.float32)
    outs = pool.run(programs.poisson_2dmesh, u, grid, **CPU)
    got = np.block([[outs[0], outs[1]], [outs[2], outs[3]]])
    mesh = ref_mesh_2d(grid)
    close_to_ref(got, ref_dist_stencil.dist_poisson_2dmesh_fn(mesh)(
        put(u, mesh, P("py", "px"))))
    np.testing.assert_allclose(got, np.asarray(poisson5_apply(
        jnp.asarray(u))), rtol=1e-4, atol=1e-4)


# --- sparse products -------------------------------------------------------------


def _padded_x(rng, A, n_pad):
    x = np.zeros(n_pad, np.float32)
    x[:A.shape[1]] = rng.random(A.shape[1]).astype(np.float32)
    return x


@pytest.mark.parametrize("name", ["poisson16", "random101"])
def test_dist_spmv(pool, rng, name):
    """Poisson 16^2 and a 101-row random matrix (padded to 104 with an
    identity tail)."""
    A = matrices.poisson2d(16) if name == "poisson16" else padded_random(101)
    mesh = ref_mesh_1d()
    dA = ref_dist_spmv.DistCSR.from_scipy(A, N).shard(mesh)
    x = _padded_x(rng, A, dA.shape[0])
    got = joined(pool.run(programs.csr_spmv, A, x, **CPU))
    close_to_ref(got, ref_dist_spmv.dist_spmv_fn(dA, mesh)(put(x, mesh)))
    m = A.shape[0]
    np.testing.assert_allclose(got[:m], A @ x[:m], rtol=1e-4, atol=1e-4)


def test_dist_spmm(pool, rng):
    A = matrices.poisson2d(16)
    B = rng.random((A.shape[1], 16)).astype(np.float32)
    got = joined(pool.run(programs.csr_spmm, A, B, **CPU))
    mesh = ref_mesh_1d()
    dA = ref_dist_spmv.DistCSR.from_scipy(A, N).shard(mesh)
    close_to_ref(got, ref_dist_spmv.dist_spmm_fn(dA, mesh, 16)(put(B, mesh)))
    np.testing.assert_allclose(got, A @ B, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["poisson16", "tridiag101"])
def test_dist_dia_spmv(pool, rng, name):
    """Bandwidth 16 <= 64 rows a shard; and a tridiagonal of 101 rows
    (padded to 104)."""
    A = matrices.poisson2d(16) if name == "poisson16" else tridiag(101)
    mesh = ref_mesh_1d()
    dA = ref_dist_dia.DistDIA.from_scipy(A, N).shard(mesh)
    x = _padded_x(rng, A, dA.shape[0])
    got = joined(pool.run(programs.dia_spmv, A, x, **CPU))
    close_to_ref(got, ref_dist_dia.dist_dia_spmv_fn(dA, mesh)(put(x, mesh)))
    m = A.shape[0]
    np.testing.assert_allclose(got[:m], A @ x[:m], rtol=1e-4, atol=1e-4)


def _check_solve(outs, ref, x_true):
    """The ranks' joined solution against x_true (1e-2) and the
    reference's (1e-4); iterations equal on every rank, within 2 of the
    reference's."""
    its = {o[1] for o in outs}
    assert len(its) == 1, its
    it = its.pop()
    x_ref, it_ref, _ = ref
    assert abs(it - int(it_ref)) <= 2, (it, int(it_ref))
    assert it < 2000
    got = joined([o[0] for o in outs])
    np.testing.assert_allclose(got, x_true, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got, np.asarray(x_ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_dist_cg(pool, rng, fmt):
    A = matrices.poisson2d(16)
    x_true = rng.random(A.shape[0]).astype(np.float32)
    b = (A @ x_true).astype(np.float32)
    mesh = ref_mesh_1d()
    if fmt == "csr":
        outs = pool.run(programs.csr_cg, A, b, 1e-5, 2000, **CPU)
        dA = ref_dist_spmv.DistCSR.from_scipy(A, N).shard(mesh)
        ref = ref_dist_spmv.dist_cg(dA, put(b, mesh), mesh, tol=1e-5,
                                    max_iter=2000)
    else:
        outs = pool.run(programs.dia_cg, A, b, 1e-5, 2000, **CPU)
        dA = ref_dist_dia.DistDIA.from_scipy(A, N).shard(mesh)
        ref = ref_dist_dia.dist_dia_cg(dA, put(b, mesh), mesh, tol=1e-5,
                                       max_iter=2000)
    _check_solve(outs, ref, x_true)


@pytest.mark.parametrize("grid,realign", [((2, 2), True), ((2, 2), False),
                                          ((1, 4), False), ((4, 1), False)])
def test_dist2d_spmv(pool, rng, grid, realign):
    A = matrices.poisson2d(16)
    pr, pc = grid
    mesh = ref_mesh_2d(grid)
    dA = ref_dist2d.Dist2DCSR.from_scipy(A, grid).shard(mesh)
    x = rng.random(dA.shape[1]).astype(np.float32)
    outs = pool.run(programs.dist2d_spmv, A, x, grid, realign, **CPU)
    # rank (i, j) = i * pc + j holds y's block j (realign) or i
    got = (joined([outs[j] for j in range(pc)]) if realign
           else joined([outs[i * pc] for i in range(pr)]))
    for r, o in enumerate(outs):                  # the copies agree
        i, j = divmod(r, pc)
        np.testing.assert_array_equal(o, outs[j] if realign else
                                      outs[i * pc])
    ref = ref_dist2d.dist2d_spmv_fn(dA, mesh, realign=realign)(
        put(x, mesh, P("px")))
    close_to_ref(got, ref)
    np.testing.assert_allclose(got, A @ x[:A.shape[0]], rtol=1e-4,
                               atol=1e-4)


def test_dist2d_cg(pool, rng):
    from libhpc_tpu.ops.solver import cg as ref_cg

    A = matrices.poisson2d(16)
    x_true = rng.random(A.shape[0]).astype(np.float32)
    b = (A @ x_true).astype(np.float32)
    outs = pool.run(programs.dist2d_cg, A, b, (2, 2), 1e-5, 2000, **CPU)
    mesh = ref_mesh_2d((2, 2))
    dA = ref_dist2d.Dist2DCSR.from_scipy(A, (2, 2)).shard(mesh)
    ref = ref_cg(ref_dist2d.dist2d_spmv_fn(dA, mesh, realign=True),
                 put(b, mesh, P("px")), tol=1e-5, max_iter=2000)
    _check_solve([outs[0], outs[1]], ref, x_true)
    assert len({o[1] for o in outs}) == 1


# --- the dry run, the benches, the example ------------------------------------


def test_dryrun_multichip_cpu():
    from libhpc_tpu_torch.dryrun import dryrun_multichip

    recs = dryrun_multichip(N, device="cpu")
    assert len(recs) == N and all(r == recs[0] for r in recs)
    assert recs[0]["grid_2d"] == (2, 2) and recs[0]["amg_iterations"] < 50


def test_overlap_bench_runs(pool, capsys):
    from libhpc_tpu_torch.bench import overlap

    effs = pool.run(overlap.run, N, 256, 256, 2, "cpu")
    assert effs[0] > 0 and len(set(effs)) == 1


def test_scaling_bench_runs(pool):
    from libhpc_tpu_torch.bench import scaling

    outs = pool.run(scaling.run, 2048, N, "cpu")
    out = outs[0]
    assert all(o == out for o in outs)
    assert out["dia"][1]["gnnz_per_s"] > 0
    assert out["sbell"][1]["gnnz_per_s"] > 0
    assert set(out["sbell"]) == set(out["dia"]) == {1, 2, 4}
    assert out["dia"][1]["efficiency"] == 1.0


def test_distributed_spmv_example(pool):
    from libhpc_tpu_torch.examples import distributed_spmv

    errs = pool.run(distributed_spmv.main, "cpu")
    assert len(errs[0]) == 3 and max(errs[0].values()) < 1e-3
