"""The port's scalar SpGEMM (ops/spgemm.py) against libhpc_tpu's on the
CPU, on every case of the reference's tests/test_solver_spgemm.py SpGEMM
section, at its tolerances: rtol 1e-4 / atol 1e-4 against scipy (1e-5 for
the identity product), nnz equal to scipy's for the windowed form.

The two packages sum duplicate products in different orders (the
reference's sort is unstable, the port's stable), so their values agree
to rounding at the same tolerance; their coordinates agree exactly. One
window of the windowed form is held against the reference's
``_spgemm_window`` on the same host deltas, with the int32 deltas of the
A values' bit patterns wrapping.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from libhpc_tpu.bench.matrices import poisson2d
from libhpc_tpu.ops import spgemm as ref_spgemm
from libhpc_tpu.sparse import CSR as RefCSR
from libhpc_tpu_torch.ops import spgemm
from libhpc_tpu_torch.sparse import CSR

from _torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=1e-4, atol=1e-4)       # test_solver_spgemm.py's


def _both(A, B):
    return ((CSR.from_scipy(A, device="cpu"), CSR.from_scipy(B, device="cpu")),
            (RefCSR.from_scipy(A), RefCSR.from_scipy(B)))


def _check(got, want, expect, tol=TOL):
    """got (port COO or CSR) and want (the reference's) against the dense
    oracle `expect`, and against each other at the same tolerance."""
    g = got.todense().numpy()
    w = np.asarray(want.todense())
    assert g.shape == w.shape == expect.shape and g.dtype == w.dtype
    np.testing.assert_allclose(g, expect, **tol)
    np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("m,k,n,da,db", [(1, 1, 1, 1.0, 1.0),
                                         (20, 30, 25, 0.2, 0.2),
                                         (64, 64, 64, 0.05, 0.05),
                                         (111, 97, 113, 0.1, 0.08)])
def test_spgemm_random(m, k, n, da, db):
    rs = np.random.RandomState(42)
    A = sps.random(m, k, density=da, format="csr", dtype=np.float32,
                   random_state=rs)
    B = sps.random(k, n, density=db, format="csr", dtype=np.float32,
                   random_state=rs)
    port, ref = _both(A, B)
    got, want = spgemm.spgemm(*port), ref_spgemm.spgemm(*ref)
    _check(got, want, (A @ B).toarray())
    # the same COO slots: coordinates exactly, values to rounding
    np.testing.assert_array_equal(got.row.numpy(), np.asarray(want.row))
    np.testing.assert_array_equal(got.col.numpy(), np.asarray(want.col))
    assert got.row.dtype == got.col.dtype == torch.int32


def test_spgemm_csr_poisson():
    A = poisson2d(8)
    port, ref = _both(A, A)
    got = spgemm.spgemm_csr(*port)
    assert type(got).__name__ == "CSR"
    _check(got, ref_spgemm.spgemm_csr(*ref), (A @ A).toarray())


def test_spgemm_expansion_size():
    A = poisson2d(4)
    port, ref = _both(A, A)
    got = spgemm.spgemm_expansion_size(*port)
    lenB = np.diff(A.indptr)
    assert got == int(lenB[A.indices].sum())
    assert got == ref_spgemm.spgemm_expansion_size(*ref)


@pytest.mark.parametrize("row_block", [7, 32, 1000])
def test_spgemm_blocked(row_block):
    rs = np.random.RandomState(23)
    A = sps.random(90, 70, density=0.1, format="csr", dtype=np.float32,
                   random_state=rs)
    B = sps.random(70, 85, density=0.1, format="csr", dtype=np.float32,
                   random_state=rs)
    port, ref = _both(A, B)
    got = spgemm.spgemm_blocked(*port, row_block=row_block)
    want = ref_spgemm.spgemm_blocked(*ref, row_block=row_block)
    _check(got, want, (A @ B).toarray())
    assert got.nnz == want.nnz


def test_spgemm_blocked_empty_product():
    """No row block of A has an entry: the one-entry zero COO."""
    A = sps.csr_matrix((5, 4), dtype=np.float32)
    B = sps.random(4, 6, density=0.5, format="csr", dtype=np.float32,
                   random_state=np.random.RandomState(1))
    port, ref = _both(A, B)
    got = spgemm.spgemm_blocked(*port, row_block=2)
    want = ref_spgemm.spgemm_blocked(*ref, row_block=2)
    assert got.nnz == want.nnz == 1 and got.shape == want.shape == (5, 6)
    assert got.data.dtype == torch.float32 and float(got.data[0]) == 0.0


def _windowed_inputs():
    rs = np.random.RandomState(7)
    A = sps.random(120, 90, density=0.08, format="csr", dtype=np.float32,
                   random_state=rs)
    B = sps.random(90, 105, density=0.07, format="csr", dtype=np.float32,
                   random_state=rs)
    # force some empty B rows
    B = B.tolil()
    B[3, :] = 0
    B[40, :] = 0
    B = B.tocsr()
    B.eliminate_zeros()
    return A, B


@pytest.mark.parametrize("window", [64, 257, 1 << 12])
def test_spgemm_windowed(window):
    """Exact-expansion windowed SpGEMM vs scipy, incl. multi-window seams,
    empty B rows (zero-length sources), and rectangular shapes."""
    A, B = _windowed_inputs()
    port, ref = _both(A, B)
    got = spgemm.spgemm_windowed(*port, window=window)
    want = ref_spgemm.spgemm_windowed(*ref, window=window)
    _check(got, want, (A @ B).toarray())
    # canonical: exact nnz, no duplicates, the reference's coordinates
    Csp = sps.csr_matrix(A @ B)
    Csp.eliminate_zeros()
    g = got.to_scipy().tocsr()
    g.eliminate_zeros()
    assert g.nnz == Csp.nnz
    np.testing.assert_array_equal(got.row.numpy(), np.asarray(want.row))
    np.testing.assert_array_equal(got.col.numpy(), np.asarray(want.col))
    assert got.data.dtype == torch.float32


@pytest.mark.parametrize("batch", [1, 3])
def test_spgemm_windowed_batch(batch):
    """Batches of G windows (the reference's vmap) give the product of one
    window a batch."""
    A, B = _windowed_inputs()
    port, ref = _both(A, B)
    got = spgemm.spgemm_windowed(*port, window=64, batch=batch)
    want = ref_spgemm.spgemm_windowed(*ref, window=64, batch=batch)
    _check(got, want, (A @ B).toarray())


def test_spgemm_windowed_poisson_identity():
    A = poisson2d(16)
    I = sps.identity(A.shape[0], format="csr", dtype=np.float32)
    port, ref = _both(A, I)
    got = spgemm.spgemm_windowed(*port, window=500)
    _check(got, ref_spgemm.spgemm_windowed(*ref, window=500), A.toarray(),
           tol=dict(rtol=1e-5, atol=1e-5))


def test_spgemm_windowed_empty_product():
    """A whose columns all hit empty B rows -> zero matrix."""
    A = sps.csr_matrix(np.array([[1.0, 0.0], [0.0, 2.0]], np.float32))
    B = sps.csr_matrix(np.zeros((2, 3), np.float32))
    port, ref = _both(A, B)
    got = spgemm.spgemm_windowed(*port)
    want = ref_spgemm.spgemm_windowed(*ref)
    assert got.shape == want.shape == (2, 3)
    assert float(got.data.abs().sum()) == 0.0
    assert got.nnz == want.nnz == 1 and got.data.dtype == torch.float32


def test_spgemm_windowed_downcasts_float64():
    """float64 A values are processed in float32, as the reference's."""
    A, B = _windowed_inputs()
    port = (CSR.from_scipy(A.astype(np.float64), device="cpu"),
            CSR.from_scipy(B, device="cpu"))
    got = spgemm.spgemm_windowed(*port, window=257)
    assert got.data.dtype == torch.float32
    np.testing.assert_allclose(got.todense().numpy(), (A @ B).toarray(),
                               **TOL)


def test_spgemm_window_matches_reference_with_wrapping_deltas():
    """One window: keys, values and n_entries of the port's (batched)
    _spgemm_window equal the reference's on the same host deltas. The A
    values alternate in sign and span many binades, so the first
    differences of their f32 bit patterns wrap in int32."""
    rs = np.random.RandomState(3)
    A = sps.random(40, 30, density=0.2, format="csr", dtype=np.float32,
                   random_state=rs)
    A.data = (A.data * np.where(np.arange(A.nnz) % 2, -1.0, 1.0)
              * np.float32(10.0) ** rs.randint(-20, 20, A.nnz)
              ).astype(np.float32)
    B = sps.random(30, 50, density=0.2, format="csr", dtype=np.float32,
                   random_state=rs)
    W = 128
    Ap, Bp = CSR.from_scipy(A, device="cpu"), CSR.from_scipy(B, device="cpu")
    plan = spgemm._symbolic_windows(Ap, Bp, W)
    ab = plan["abits_l"].astype(np.int64)
    assert np.abs(np.diff(ab)).max() >= 2**31          # the deltas wrap
    for b0 in (0, plan["n_win"] - 1):                  # first and last
        deltas, rmin, nb = spgemm._prep_batch(plan, W, 1, b0)
        assert nb == 1
        got = spgemm._spgemm_window(*(torch.from_numpy(a) for a in deltas),
                                    Bp.indices, Bp.data, W=W,
                                    SRC=plan["SRC"], CBITS=plan["CBITS"])
        want = ref_spgemm._spgemm_window(
            *(jnp.asarray(a[0]) for a in deltas), jnp.asarray(B.indices),
            jnp.asarray(B.data), W=W, SRC=plan["SRC"], CBITS=plan["CBITS"])
        k, v, n = (np.asarray(w) for w in want)
        assert int(got[2][0]) == int(n) > 0
        np.testing.assert_array_equal(got[0][0].numpy(), k)
        np.testing.assert_allclose(got[1][0].numpy(), v, rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max())
    C = spgemm.spgemm_windowed(Ap, Bp, window=W)
    np.testing.assert_allclose(C.todense().numpy(), (A @ B).toarray(),
                               rtol=1e-4, atol=1e-4 * abs(A @ B).max())


def test_spgemm_windowed_rejects_a_wide_window():
    """A window whose rows cannot be packed beside the column bits raises
    the reference's ValueError."""
    n = 1 << 20                     # 20 column bits leave 11 for the rows
    A = sps.identity(4096, format="csr", dtype=np.float32)
    B = sps.csr_matrix((np.ones(4096, np.float32),
                        (np.arange(4096), np.full(4096, n - 1))),
                       shape=(4096, n))
    port, ref = _both(A, B)
    with pytest.raises(ValueError, match="too wide to pack") as got:
        spgemm.spgemm_windowed(*port, window=4096)
    with pytest.raises(ValueError, match="too wide to pack") as want:
        ref_spgemm.spgemm_windowed(*ref, window=4096)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fn", ["spgemm", "spgemm_csr", "spgemm_blocked",
                                "spgemm_windowed"])
def test_spgemm_shape_mismatch(fn):
    A = sps.random(6, 5, density=0.5, format="csr", dtype=np.float32,
                   random_state=np.random.RandomState(0))
    port, ref = _both(A, A)
    with pytest.raises(ValueError, match="shape mismatch") as got:
        getattr(spgemm, fn)(*port)
    with pytest.raises(ValueError, match="shape mismatch") as want:
        getattr(ref_spgemm, fn)(*ref)
    assert str(got.value) == str(want.value)
