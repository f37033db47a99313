"""The port's DistSBELL (parallel/dist_sbell.py) against libhpc_tpu's on the
CPU.

Containers: ``DistSBELL.from_scipy`` equals the reference's array by array
and static by static at 1, 4 and 8 shards, the chunk statics and bounds of
the reference's VMEM planner included, with ``VMEM_CAP`` lowered in both
packages to the cap at which ``test_dist_sbell_chunked_shards`` makes the
reference chunk (the port's matvec has no plan). Functions: the
distributed matvec on a module-scoped pool of 4 gloo ranks against the
reference's at 4 shards (Pallas in interpret mode, 4 of the 8 virtual
devices) at rtol 1e-5, atol 1e-6 * max|y|, and against scipy at the
reference test's 1e-4. The shard-local product, which the card's smoke run
calls shard by shard, is held against scipy on every shard of an 8-way
partition, and the padding cases of a shard's tile stream (no real tile;
every real tile in stripe 0; a diagonal far set folded into the
off-diagonal one) are checked on the shards' own containers.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libhpc_tpu.ops import spmv_pallas as ref_spmv_pallas
from libhpc_tpu.parallel import dist_sbell as ref_dist_sbell
from libhpc_tpu_torch.bench import matrices
from libhpc_tpu_torch.ops import spmv_sbell
from libhpc_tpu_torch.parallel import programs
from libhpc_tpu_torch.parallel.dist_sbell import DistSBELL, shard_matvec
from libhpc_tpu_torch.parallel.mesh import RankPool

from _torch_port import assert_same_container
from _torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 4


def banded(n=9000):
    return sps.diags([np.ones(n - k) for k in (0, 1, 2, 3)], [0, -1, 2, 17],
                     shape=(n, n), format="csr", dtype=np.float32)


MATRICES = {
    "fem": lambda: matrices.block_random(1500, block=8, blocks_per_row=6,
                                         seed=5),
    "poisson96": lambda: matrices.poisson2d(96),
    "banded": banded,
    "fem3000": lambda: matrices.block_random(3000, block=8,
                                             blocks_per_row=6, seed=5),
}


@pytest.fixture(scope="module")
def pool():
    with RankPool(N, "cpu", timeout_s=90) as p:
        yield p


def chunking_cap(A, n_shards, monkeypatch):
    """The reference test's walk: the first cap whose off-diagonal plan
    splits into several chunks, set in the reference's planner."""
    for cap in (68_000, 60_000, 52_000, 44_000):
        monkeypatch.setattr(ref_spmv_pallas, "VMEM_CAP", cap)
        try:
            cand = ref_dist_sbell.DistSBELL.from_scipy(A, n_shards)
        except ValueError:
            break
        if cand.offd_chunk is not None and cand.offd_bounds.shape[1] > 1:
            return cap
    raise AssertionError("no cap makes a multi-chunk off-diagonal plan")


@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("name", ["fem", "poisson96"])
def test_dist_sbell_container_equals_reference(name, n_shards):
    A = MATRICES[name]()
    assert_same_container(DistSBELL.from_scipy(A, n_shards),
                          ref_dist_sbell.DistSBELL.from_scipy(A, n_shards))


@pytest.mark.parametrize("n_shards", [4, 8])
def test_dist_sbell_chunk_plans_equal_reference(monkeypatch, n_shards):
    """With VMEM_CAP lowered the reference's shards chunk: the port
    carries the same statics (spc, win, gsteps) and bounds."""
    A = MATRICES["fem3000"]()
    cap = chunking_cap(A, n_shards, monkeypatch)
    monkeypatch.setattr(spmv_sbell, "VMEM_CAP", cap)
    ref = ref_dist_sbell.DistSBELL.from_scipy(A, n_shards)
    got = DistSBELL.from_scipy(A, n_shards)
    assert got.offd_chunk is not None and got.offd_bounds.shape[1] > 1
    assert_same_container(got, ref)


def test_dist_sbell_banded_container_equals_reference():
    A = banded()
    assert_same_container(DistSBELL.from_scipy(A, N),
                          ref_dist_sbell.DistSBELL.from_scipy(A, N))


def _ref_matvec(A, n_shards):
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("x",))
    dA = ref_dist_sbell.DistSBELL.from_scipy(A, n_shards).shard(mesh)
    x = np.linspace(-1.0, 1.0, dA.shape[1]).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x")))
    return x, np.asarray(ref_dist_sbell.dist_sbell_spmv_fn(dA, mesh)(xs))


def _check_y(y, A, x, ref):
    np.testing.assert_allclose(y, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    m = A.shape[0]
    np.testing.assert_allclose(y[:m], A @ x[:A.shape[1]], rtol=1e-4,
                               atol=1e-4)
    assert np.allclose(y[m:], 0.0)


@pytest.mark.parametrize("name", ["fem", "poisson96", "banded"])
def test_dist_sbell_spmv(pool, name):
    A = MATRICES[name]()
    x, ref = _ref_matvec(A, N)
    y = np.concatenate(pool.run(programs.sbell_spmv, A, x,
                                device_type="cpu"))
    _check_y(y, A, x, ref)


def test_dist_sbell_chunked_shards(pool, monkeypatch):
    """The reference's shards past its VMEM budget run its chunked kernel;
    the port's kernel reads x from global memory and ignores the plan, and
    gives the same y."""
    A = MATRICES["fem3000"]()
    chunking_cap(A, N, monkeypatch)
    x, ref = _ref_matvec(A, N)
    y = np.concatenate(pool.run(programs.sbell_spmv, A, x,
                                device_type="cpu"))
    _check_y(y, A, x, ref)


def _all_shards(A, n_shards):
    """y of every shard's shard_matvec with xg the global x, joined."""
    dS = DistSBELL.from_scipy(A, n_shards)
    x = torch.linspace(-1.0, 1.0, dS.shape[1])
    rl = dS.rows_local
    ys = [shard_matvec(dS.shard_blocks(s, "cpu"), x[s * rl:(s + 1) * rl], x)
          for s in range(n_shards)]
    return dS, x.numpy(), torch.cat(ys).numpy()


@pytest.mark.parametrize("name", ["fem", "banded"])
def test_shard_matvec_every_shard_of_8(name):
    A = MATRICES[name]()
    _, x, y = _all_shards(A, 8)
    np.testing.assert_allclose(y[:A.shape[0]], A @ x[:A.shape[1]],
                               rtol=1e-4, atol=1e-4)


def _real_tile_count(sb):
    v = sb.vflat.reshape(sb.n_tiles, -1)
    return int(((v != 0).any(dim=1) | (sb.meta != 0).any(dim=1)).sum())


def test_shard_with_no_real_tile():
    """At one shard the off-diagonal block is empty: its tile offsets are
    all 0 and it adds nothing."""
    A = MATRICES["fem"]()
    dS, x, y = _all_shards(A, 1)
    offd = dS.shard_blocks(0, "cpu").offd
    assert offd.k_max == 0 and int(offd.tile_ptr.abs().sum()) == 0
    np.testing.assert_allclose(y[:A.shape[0]], A @ x[:A.shape[1]],
                               rtol=1e-4, atol=1e-4)


def test_shard_tiles_all_in_stripe_0():
    """One stripe a shard, shard 0 much denser than the others: the other
    shards' streams are padded with zero stripe-0 tiles, which their tile
    offsets leave out (the kernel's deepest stripe is a real one)."""
    nb = 512                                     # 4 shards of 1024 rows
    rs = np.random.RandomState(3)
    rows, cols = [np.arange(nb)], [np.arange(nb)]
    for k in range(1, 12):                       # shard 0: 12 blocks a row
        rows.append(np.arange(128))
        cols.append(np.minimum(np.arange(128) + k, 127))
    br = np.concatenate(rows)
    bc = np.concatenate(cols)
    Ab = sps.coo_matrix((np.ones(br.size), (br, bc)), shape=(nb, nb)).tocsr()
    Ab.data[:] = 1.0
    A = sps.kron(Ab, sps.csr_matrix(rs.rand(8, 8))).tocsr().astype(
        np.float32)
    dS, x, y = _all_shards(A, N)
    for s in range(N):
        diag = dS.shard_blocks(s, "cpu").diag
        assert diag.k_max == _real_tile_count(diag)
    assert dS.shard_blocks(N - 1, "cpu").diag.k_max < dS.diag_vflat.shape[1] \
        // 64
    np.testing.assert_allclose(y[:A.shape[0]], A @ x[:A.shape[1]],
                               rtol=1e-4, atol=1e-4)
    assert_same_container(dS, ref_dist_sbell.DistSBELL.from_scipy(A, N))


def test_diag_far_folded_into_offd():
    """A block-row with one more block than the rest of its stripe makes a
    slice thinner than MIN_OCCUPANCY in the diagonal block: it goes to the
    far set, its block-columns shifted by s * rows_local / 8."""
    nb = 512
    Ab = sps.identity(nb, format="lil")
    for s in range(N):
        Ab[s * 128 + 5, s * 128 + 40] = 1.0      # inside shard s's columns
    A = sps.kron(Ab.tocsr(), sps.csr_matrix(
        np.arange(1.0, 65.0).reshape(8, 8))).tocsr().astype(np.float32)
    dS, x, y = _all_shards(A, N)
    assert dS.has_far
    assert_same_container(dS, ref_dist_sbell.DistSBELL.from_scipy(A, N))
    for s in range(N):
        cols = dS.far_cols[s].numpy()
        assert (s * 128 + 40) in cols
    np.testing.assert_allclose(y[:A.shape[0]], A @ x[:A.shape[1]],
                               rtol=1e-4, atol=1e-4)
