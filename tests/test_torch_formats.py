"""The port's COO, BSR, BELL and BandedHybrid containers and the SpMV /
SpMM of every format (ops/spmv.py, ops/spmm.py) against libhpc_tpu's on
the CPU, and against the scipy oracles of the reference's
tests/test_spmv_spmm.py and tests/test_containers.py.

Containers are equal array by array (index arrays and values exactly,
static fields equal). Products: float32 at the reference tests' bounds
against scipy (rtol 1e-4 with atol 1e-5 to 1e-3; BELL 2e-4) and against
the reference's result on the same inputs at rtol 1e-5 / atol 1e-5 of
the largest entry (the two packages add in different orders).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from libhpc_tpu.bench.matrices import block_random, poisson2d
from libhpc_tpu.ops import spmm as ref_spmm
from libhpc_tpu.ops import spmv as ref_spmv
from libhpc_tpu.sparse import BELL as RefBELL
from libhpc_tpu.sparse import BSR as RefBSR
from libhpc_tpu.sparse import COO as RefCOO
from libhpc_tpu.sparse import CSR as RefCSR
from libhpc_tpu.sparse import BandedHybrid as RefHybrid
from libhpc_tpu_torch.ops import spmm, spmv
from libhpc_tpu_torch.sparse import BELL, BSR, COO, CSR, BandedHybrid

from _torch_port import assert_same_container, port_of
from _torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random(m, n, density, seed, fmt="csr"):
    return sps.random(m, n, density=density, format=fmt, dtype=np.float32,
                      random_state=np.random.RandomState(seed))


def _with_empty_rows(m, n, seed):
    """A random matrix whose rows 0, 3, and the last are empty."""
    A = _random(m, n, 0.15, seed).tolil()
    for r in (0, 3, m - 1):
        A[r, :] = 0
    A = A.tocsr()
    A.eliminate_zeros()
    return A


def _same_as_ref(got, want, rtol=1e-5):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0))


# -- COO -------------------------------------------------------------------

@pytest.mark.parametrize("shape,density", [((1, 1), 1.0), ((13, 7), 0.3),
                                           ((80, 90), 0.1)])
def test_coo_builders_match_reference(shape, density):
    A = _random(*shape, density, 5, fmt="coo")
    ref = RefCOO.from_scipy(A)
    port = COO.from_scipy(A, device="cpu")
    assert_same_container(port, ref)
    assert_same_container(port_of(ref), ref)
    assert_same_container(COO.from_dense(A.toarray(), device="cpu"),
                          RefCOO.from_dense(A.toarray()))
    np.testing.assert_array_equal(port.todense().numpy(), A.toarray())
    assert (port.to_scipy().tocsr() != A.tocsr()).nnz == 0
    assert port.nnz == ref.nnz and port.dtype == torch.float32


@pytest.mark.parametrize("order", ["row", "col", "morton"])
def test_coo_sort_indices_matches_reference(rng, order):
    A = _random(50, 60, 0.1, 3, fmt="coo")
    perm = rng.permutation(A.nnz)
    parts = (A.row[perm].astype(np.int32), A.col[perm].astype(np.int32),
             A.data[perm])
    ref = RefCOO(*(jnp.asarray(p) for p in parts), shape=A.shape)
    port = COO(*(_t(p) for p in parts), shape=A.shape)
    assert_same_container(port.sort_indices(order), ref.sort_indices(order))
    np.testing.assert_array_equal(port.sort_indices(order).todense().numpy(),
                                  A.toarray())
    with pytest.raises(ValueError, match="unknown order"):
        port.sort_indices("diagonal")


def test_coo_sum_duplicates_matches_reference(rng):
    row = np.array([0, 0, 1, 0, 2, 1, 4, 4], np.int32)
    col = np.array([1, 1, 2, 1, 0, 2, 3, 0], np.int32)
    dat = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0], np.float32)
    ref = RefCOO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(dat),
                 shape=(5, 5)).sum_duplicates()
    port = COO(_t(row), _t(col), _t(dat), shape=(5, 5)).sum_duplicates()
    assert_same_container(port, ref)
    expect = np.zeros((5, 5), np.float32)
    expect[0, 1], expect[1, 2], expect[2, 0] = 7.0, 9.0, 5.0
    expect[4, 3], expect[4, 0] = 7.0, 8.0
    np.testing.assert_array_equal(port.todense().numpy(), expect)
    # many duplicates of integer values: exact sums in any order
    r = rng.integers(0, 9, 400).astype(np.int32)
    c = rng.integers(0, 7, 400).astype(np.int32)
    d = rng.integers(-4, 5, 400).astype(np.float32)
    ref = RefCOO(jnp.asarray(r), jnp.asarray(c), jnp.asarray(d),
                 shape=(9, 7)).sum_duplicates()
    port = COO(_t(r), _t(c), _t(d), shape=(9, 7)).sum_duplicates()
    assert_same_container(port, ref)


@pytest.mark.parametrize("shape", [(50, 60), (30, 30)])
def test_coo_csr_bridges_match_reference(rng, shape):
    A = _with_empty_rows(*shape, seed=8).tocoo()
    perm = rng.permutation(A.nnz)
    parts = (A.row[perm].astype(np.int32), A.col[perm].astype(np.int32),
             A.data[perm])
    ref = RefCOO(*(jnp.asarray(p) for p in parts), shape=A.shape)
    port = COO(*(_t(p) for p in parts), shape=A.shape)
    csr = port.tocsr()
    assert_same_container(csr, ref.tocsr())
    assert_same_container(csr, RefCSR.from_scipy(A))
    assert_same_container(CSR.from_coo(port), RefCSR.from_coo(ref))
    ref_csr = RefCSR.from_scipy(A)
    assert_same_container(CSR.from_scipy(A, device="cpu").tocoo(),
                          ref_csr.tocoo())


# -- BSR / BELL ------------------------------------------------------------

@pytest.mark.parametrize("shape,block,morton", [
    ((64, 64), 8, False), ((64, 64), 8, True), ((60, 52), 8, False),
    ((33, 31), 16, True), ((120, 120), 16, False)])
def test_bsr_builders_match_reference(shape, block, morton):
    A = _random(*shape, 0.1, 13)
    ref = RefBSR.from_scipy(A, block=block, morton=morton)
    port = BSR.from_scipy(A, block=block, morton=morton, device="cpu")
    assert_same_container(port, ref)
    assert_same_container(port_of(ref), ref)
    assert port.b == ref.b and port.nblocks == ref.nblocks
    assert port.n_block_rows == ref.n_block_rows
    assert port.nnz_stored == ref.nnz_stored
    np.testing.assert_array_equal(port.block_row_of_block().numpy(),
                                  np.asarray(ref.block_row_of_block()))
    dense = port.todense().numpy()
    np.testing.assert_array_equal(dense, np.asarray(ref.todense()))
    np.testing.assert_array_equal(dense[:shape[0], :shape[1]], A.toarray())
    assert np.all(dense[shape[0]:, :] == 0) and np.all(dense[:, shape[1]:]
                                                       == 0)
    assert port.fill_ratio() == ref.fill_ratio() >= 1.0
    assert (port.to_scipy() != ref.to_scipy()).nnz == 0
    if not morton:
        csr = CSR.from_scipy(A, device="cpu")
        assert_same_container(csr.to_bsr(block), RefCSR.from_scipy(A)
                              .to_bsr(block))
        assert_same_container(BSR.from_dense(A.toarray(), block=block,
                                             device="cpu"),
                              RefBSR.from_dense(A.toarray(), block=block))


@pytest.mark.parametrize("shape,block", [((300, 280), 8), ((128, 128), 8),
                                         ((64, 48), 16)])
def test_bell_builders_match_reference(shape, block):
    A = _random(*shape, 0.05, 7)
    ref = RefBELL.from_scipy(A, block=block)
    port = BELL.from_scipy(A, block=block, device="cpu")
    assert_same_container(port, ref)
    assert_same_container(port_of(ref), ref)
    assert_same_container(BELL.from_bsr(BSR.from_scipy(A, block=block,
                                                       device="cpu")), ref)
    assert (port.K, port.b, port.nnz_stored) == (ref.K, ref.b,
                                                 ref.nnz_stored)
    assert port.fill_ratio() == ref.fill_ratio()
    np.testing.assert_array_equal(port.todense().numpy(),
                                  np.asarray(ref.todense()))
    np.testing.assert_array_equal(port.todense().numpy()[:shape[0],
                                                         :shape[1]],
                                  A.toarray())


# -- BandedHybrid ----------------------------------------------------------

def _hybrid_inputs():
    rs = np.random.RandomState(11)
    blk = block_random(64, block=4, blocks_per_row=5, seed=7)
    p = rs.permutation(blk.shape[0])
    return {"random": _random(150, 150, 0.05, 31),
            "poisson16": poisson2d(16),
            "scrambled": blk[p][:, p].tocsr(),
            "empty_rows": _with_empty_rows(90, 90, 4)}


@pytest.mark.parametrize("name,max_diags,rcm", [
    ("random", 16, False), ("random", 16, True), ("poisson16", 8, False),
    ("scrambled", 32, True), ("scrambled", 32, False),
    ("empty_rows", 8, True)])
def test_hybrid_builder_matches_reference(name, max_diags, rcm):
    A = _hybrid_inputs()[name]
    ref = RefHybrid.from_scipy(A, max_diags=max_diags, rcm=rcm)
    port = BandedHybrid.from_scipy(A, max_diags=max_diags, rcm=rcm,
                                   device="cpu")
    assert_same_container(port, ref)          # perm, iperm, band, rest
    assert_same_container(port_of(ref), ref)
    assert 0.0 < port.coverage <= 1.0
    if name == "poisson16":
        assert port.coverage == 1.0
    x = np.random.default_rng(1).random(A.shape[1]).astype(np.float32)
    got = port @ x
    np.testing.assert_allclose(got.numpy(), A @ x, rtol=1e-4, atol=1e-4)
    _same_as_ref(spmv.hybrid_spmv(port, _t(x)),
                 ref_spmv.hybrid_spmv(ref, jnp.asarray(x)))


def test_hybrid_rcm_improves_coverage():
    A = _hybrid_inputs()["scrambled"]
    plain = BandedHybrid.from_scipy(A, max_diags=32, rcm=False,
                                    device="cpu")
    rcm = BandedHybrid.from_scipy(A, max_diags=32, rcm=True, device="cpu")
    assert rcm.coverage > plain.coverage


def test_hybrid_rejects_a_rectangle():
    with pytest.raises(ValueError, match="square"):
        BandedHybrid.from_scipy(_random(20, 30, 0.2, 1), device="cpu")


# -- SpMV ------------------------------------------------------------------

@pytest.mark.parametrize("block", [8, 16])
def test_bsr_spmv(rng, block):
    A = _random(120, 120, 0.05, 3)
    bsr = BSR.from_scipy(A, block=block, device="cpu")
    ref = RefBSR.from_scipy(A, block=block)
    xp = np.zeros(bsr.shape[1], np.float32)
    xp[:120] = rng.random(120).astype(np.float32)
    got = spmv.bsr_spmv(bsr, _t(xp))
    np.testing.assert_allclose(got.numpy()[:120], A @ xp[:120], rtol=1e-4,
                               atol=1e-4)
    _same_as_ref(got, ref_spmv.bsr_spmv(ref, jnp.asarray(xp)))
    np.testing.assert_array_equal((bsr @ xp).numpy(), got.numpy())


@pytest.mark.parametrize("shape", [(80, 90), (90, 40)])
def test_coo_spmv(rng, shape):
    A = _with_empty_rows(*shape, seed=5).tocoo()
    x = rng.random(shape[1]).astype(np.float32)
    got = spmv.coo_spmv(COO.from_scipy(A, device="cpu"), _t(x))
    np.testing.assert_allclose(got.numpy(), A @ x, rtol=1e-4, atol=1e-5)
    _same_as_ref(got, ref_spmv.coo_spmv(RefCOO.from_scipy(A),
                                        jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(300, 280), (128, 128), (40, 96)])
def test_bell_spmv(rng, shape):
    A = _random(*shape, 0.03, 5)
    bell = BELL.from_scipy(A, block=8, device="cpu")
    x = rng.random(bell.shape[1], dtype=np.float32)
    got = spmv.bell_spmv(bell, _t(x))
    np.testing.assert_allclose(got.numpy()[:shape[0]], A @ x[:shape[1]],
                               rtol=2e-4, atol=2e-4)
    _same_as_ref(got, ref_spmv.bell_spmv(RefBELL.from_scipy(A, block=8),
                                         jnp.asarray(x)))
    np.testing.assert_array_equal((bell @ x).numpy(), got.numpy())


@pytest.mark.parametrize("shape", [(1, 1), (13, 7), (297, 111), (60, 150)])
def test_csr_spmv_t(rng, shape):
    A = _with_empty_rows(*shape, seed=6) if shape[0] > 3 else \
        _random(*shape, 1.0, 6)
    y = rng.random(shape[0]).astype(np.float32)
    csr = CSR.from_scipy(A, device="cpu")
    got = spmv.csr_spmv_t(csr, _t(y))
    assert got.shape == (shape[1],)
    np.testing.assert_allclose(got.numpy(), A.T @ y, rtol=1e-4, atol=1e-5)
    _same_as_ref(got, ref_spmv.csr_spmv_t(RefCSR.from_scipy(A),
                                          jnp.asarray(y)))


# -- SpMM ------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 64])
def test_csr_spmm(rng, c):
    A = _with_empty_rows(100, 80, seed=11)
    B = rng.random((80, c)).astype(np.float32)
    csr = CSR.from_scipy(A, device="cpu")
    got = spmm.csr_spmm(csr, _t(B))
    np.testing.assert_allclose(got.numpy(), A @ B, rtol=1e-4, atol=1e-4)
    _same_as_ref(got, ref_spmm.csr_spmm(RefCSR.from_scipy(A),
                                        jnp.asarray(B)))
    np.testing.assert_array_equal((csr @ B).numpy(), got.numpy())


@pytest.mark.parametrize("name", ["poisson10", "rect"])
def test_ell_spmm(rng, name):
    from libhpc_tpu.sparse import ELL as RefELL
    from libhpc_tpu_torch.sparse import ELL

    A = poisson2d(10) if name == "poisson10" else _with_empty_rows(70, 50, 2)
    B = rng.random((A.shape[1], 64)).astype(np.float32)
    got = spmm.ell_spmm(ELL.from_scipy(A, device="cpu"), _t(B))
    np.testing.assert_allclose(got.numpy(), A @ B, rtol=1e-4, atol=1e-3)
    _same_as_ref(got, ref_spmm.ell_spmm(RefELL.from_scipy(A),
                                        jnp.asarray(B)))


@pytest.mark.parametrize("shape,c", [((64, 64), 32), ((60, 52), 64)])
def test_bsr_spmm(rng, shape, c):
    A = _random(*shape, 0.1, 13)
    bsr = BSR.from_scipy(A, block=8, device="cpu")
    B = np.zeros((bsr.shape[1], c), np.float32)
    B[:shape[1]] = rng.random((shape[1], c)).astype(np.float32)
    got = spmm.bsr_spmm(bsr, _t(B))
    assert got.shape == (bsr.shape[0], c)
    np.testing.assert_allclose(got.numpy()[:shape[0]], A @ B[:shape[1]],
                               rtol=1e-4, atol=1e-3)
    _same_as_ref(got, ref_spmm.bsr_spmm(RefBSR.from_scipy(A, block=8),
                                        jnp.asarray(B)))


# -- result dtypes and mixed operands (ROADMAP Queue 3, F9-F12) -------------

INT_DTYPES = (np.int8, np.int16, np.int32, np.uint8)


def _int_matrix(dtype, n=8, seed=0):
    """A seeded n x n integer matrix of `dtype`, half its entries zero."""
    rs = np.random.RandomState(seed)
    d = rs.randint(-3, 4, (n, n)) * (rs.rand(n, n) < 0.5)
    return sps.csr_matrix((np.abs(d) if dtype == np.uint8 else d)
                          .astype(dtype))


def _same_exactly(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_ell_and_hybrid_integer_dtypes_match_reference(dtype):
    """F9: ell_spmv (and hybrid_spmv through it) sum integers as jnp.sum
    does: int32 for int8 / int16 / int32, uint32 for uint8, wrapping."""
    from libhpc_tpu.sparse import ELL as RefELL
    from libhpc_tpu_torch.sparse import ELL

    A = _int_matrix(dtype)
    x = np.arange(8).astype(dtype)
    _same_exactly(spmv.ell_spmv(ELL.from_scipy(A, device="cpu"), _t(x)),
                  ref_spmv.ell_spmv(RefELL.from_scipy(A), jnp.asarray(x)))
    hyb = BandedHybrid.from_scipy(A, max_diags=2, device="cpu")
    _same_exactly(spmv.hybrid_spmv(hyb, _t(x)),
                  ref_spmv.hybrid_spmv(RefHybrid.from_scipy(A, max_diags=2),
                                       jnp.asarray(x)))
    # sums past the dtype's range wrap as the reference's do
    big = {np.int8: 100, np.int16: 30000, np.int32: 2**30, np.uint8: 200}
    Aw = sps.csr_matrix(np.full((2, 2), big[dtype], dtype))
    xw = np.full(2, 4 if dtype == np.int32 else big[dtype], dtype)
    _same_exactly(spmv.ell_spmv(ELL.from_scipy(Aw, device="cpu"), _t(xw)),
                  ref_spmv.ell_spmv(RefELL.from_scipy(Aw), jnp.asarray(xw)))


@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_block_products_integer_dtypes_match_reference(dtype):
    """F10: bell_spmv (and bsr_spmv, ell_spmm, bsr_spmm) return the
    operator's own dtype, wrapping, as the reference's
    preferred_element_type does."""
    from libhpc_tpu.sparse import ELL as RefELL
    from libhpc_tpu_torch.sparse import ELL

    for A in (_int_matrix(dtype),
              sps.csr_matrix(np.full((4, 4), 100, dtype))):
        n = A.shape[1]
        x = (np.arange(n) + 90).astype(dtype)
        B = np.stack([x, x[::-1]], axis=1)
        bell, ref_bell = (BELL.from_scipy(A, block=2, device="cpu"),
                          RefBELL.from_scipy(A, block=2))
        bsr, ref_bsr = (BSR.from_scipy(A, block=2, device="cpu"),
                        RefBSR.from_scipy(A, block=2))
        _same_exactly(spmv.bell_spmv(bell, _t(x)),
                      ref_spmv.bell_spmv(ref_bell, jnp.asarray(x)))
        _same_exactly(spmv.bsr_spmv(bsr, _t(x)),
                      ref_spmv.bsr_spmv(ref_bsr, jnp.asarray(x)))
        _same_exactly(spmm.ell_spmm(ELL.from_scipy(A, device="cpu"), _t(B)),
                      ref_spmm.ell_spmm(RefELL.from_scipy(A),
                                        jnp.asarray(B)))
        _same_exactly(spmm.bsr_spmm(bsr, _t(B)),
                      ref_spmm.bsr_spmm(ref_bsr, jnp.asarray(B)))


@pytest.mark.parametrize("op_dtype,x_dtype", [
    (np.float32, np.float64), (np.float32, np.int32),
    (np.float32, "bfloat16"), (np.int8, np.float32), (np.int32, np.float32),
    ("bfloat16", np.float32)])
def test_block_products_take_another_rhs_dtype(op_dtype, x_dtype):
    """F11: a right-hand side of another dtype than the operator's is
    converted as the reference converts it (to the operator's dtype, a
    float saturating into an integer one), not refused."""
    from libhpc_tpu.sparse import ELL as RefELL
    from libhpc_tpu_torch.sparse import ELL

    A = _random(16, 16, 0.4, 9)
    if op_dtype in (np.int8, np.int32):
        A.data = np.round(A.data * 6 - 3)
    rs = np.random.RandomState(4)
    x = (rs.rand(16) * 8 - 4).astype(np.float32)
    x[3] = 300.0                          # saturates into int8
    B = np.stack([x, -x], axis=1)
    ops = {}
    for name, port_cls, ref_cls, kw in (
            ("bsr", BSR, RefBSR, dict(block=4)),
            ("bell", BELL, RefBELL, dict(block=4)),
            ("ell", ELL, RefELL, {})):
        ref = _values_astype(ref_cls.from_scipy(A, **kw), op_dtype)
        ops[name] = (port_of(ref), ref)

    def rhs(a):
        return (jnp.asarray(a, jnp.bfloat16) if x_dtype == "bfloat16"
                else jnp.asarray(np.asarray(a).astype(x_dtype)))

    def port_rhs(a):
        if x_dtype == "bfloat16":
            return _t(np.asarray(a, np.float32)).to(torch.bfloat16)
        return _t(np.asarray(a).astype(x_dtype))

    cases = [
        (spmv.bsr_spmv(ops["bsr"][0], port_rhs(x)),
         ref_spmv.bsr_spmv(ops["bsr"][1], rhs(x))),
        (spmv.bell_spmv(ops["bell"][0], port_rhs(x)),
         ref_spmv.bell_spmv(ops["bell"][1], rhs(x))),
        (spmm.bsr_spmm(ops["bsr"][0], port_rhs(B)),
         ref_spmm.bsr_spmm(ops["bsr"][1], rhs(B))),
        (spmm.ell_spmm(ops["ell"][0], port_rhs(B)),
         ref_spmm.ell_spmm(ops["ell"][1], rhs(B))),
    ]
    if x_dtype != "bfloat16":             # the matmul operators take numpy
        cases += [(ops["bsr"][0] @ np.asarray(x).astype(x_dtype),
                   ops["bsr"][1] @ np.asarray(x).astype(x_dtype)),
                  (ops["bell"][0] @ np.asarray(x).astype(x_dtype),
                   ops["bell"][1] @ np.asarray(x).astype(x_dtype))]
    for got, want in cases:
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(got.float().numpy(),
                                       want.astype(np.float32), rtol=2e-2,
                                       atol=2e-2 * np.abs(want).max())
        elif np.issubdtype(want.dtype, np.integer):
            _same_exactly(got, want)
        else:
            _same_as_ref(got, want)


def _values_astype(ref, dtype):
    """The reference container with its values (blocks / vals) in
    `dtype`."""
    import dataclasses

    dt = jnp.bfloat16 if dtype == "bfloat16" else dtype
    name = "vals" if hasattr(ref, "vals") else "blocks"
    return dataclasses.replace(ref, **{name: getattr(ref, name).astype(dt)})


@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_dia_integer_data_with_float_x(dtype):
    """F12: dia_spmv / dia_spmv_t of an integer DIA with a float x return
    the promoted float32, as the reference's do, instead of raising."""
    from libhpc_tpu.sparse import DIA as RefDIA
    from libhpc_tpu_torch.sparse import DIA

    A = sps.diags([np.arange(1, 8), np.arange(8) % 3, np.arange(1, 6)],
                  [-1, 0, 3], shape=(8, 8), format="csr").astype(dtype)
    x = np.linspace(-1.5, 2.5, 8).astype(np.float32)
    dia, ref = DIA.from_scipy(A, device="cpu"), RefDIA.from_scipy(A)
    _same_as_ref(spmv.dia_spmv(dia, _t(x)),
                 ref_spmv.dia_spmv(ref, jnp.asarray(x)))
    _same_as_ref(spmv.dia_spmv_t(dia, _t(x)),
                 ref_spmv.dia_spmv_t(ref, jnp.asarray(x)))
    _same_as_ref(dia @ x, ref @ x)
    xi = np.arange(8).astype(dtype)
    _same_exactly(spmv.dia_spmv(dia, _t(xi)),
                  ref_spmv.dia_spmv(ref, jnp.asarray(xi)))


def test_matmul_takes_a_list_and_numpy_on_the_operator_device():
    """F12: every container's @ takes a Python list as jnp.asarray does
    (floats float32), and DIA @ moves a numpy x to the DIA's device (a
    meta-device DIA shows the move without a card)."""
    from libhpc_tpu.sparse import DIA as RefDIA
    from libhpc_tpu_torch.sparse import DIA

    A = poisson2d(4)
    xs = [float(v) for v in np.linspace(-1.0, 1.0, 16)]
    for port, ref in ((CSR.from_scipy(A, device="cpu"), RefCSR.from_scipy(A)),
                      (BSR.from_scipy(A, block=4, device="cpu"),
                       RefBSR.from_scipy(A, block=4)),
                      (BELL.from_scipy(A, block=4, device="cpu"),
                       RefBELL.from_scipy(A, block=4)),
                      (BandedHybrid.from_scipy(A, device="cpu"),
                       RefHybrid.from_scipy(A)),
                      (DIA.from_scipy(A, device="cpu"),
                       RefDIA.from_scipy(A))):
        _same_as_ref(port @ xs, ref @ xs)
    meta = DIA.from_scipy(A, device="cpu").to("meta")
    y = meta @ np.ones(16, np.float32)
    assert y.device.type == "meta" and y.shape == (16,)
    assert y.dtype == torch.float32
