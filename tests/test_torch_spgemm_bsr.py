"""The port's block SpGEMM (ops/spgemm_bsr.py) against libhpc_tpu's on
the CPU, on every case of the reference's tests/test_spgemm_bsr.py, at
its tolerance: max |C - scipy| < 1e-4 max(|scipy|, 1).

The host symbolic pass must equal the reference's array by array. The
blocks agree with the reference's to rounding: the reference adds its b
terms in the order j = 0 .. b-1 (``mxu=False`` does too; ``mxu=True`` is
one ``torch.bmm``).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from libhpc_tpu.bench.matrices import poisson2d
from libhpc_tpu.ops import spgemm_bsr as ref_mod
from libhpc_tpu.sparse.bsr import BSR as RefBSR
from libhpc_tpu_torch.ops import spgemm_bsr as port_mod
from libhpc_tpu_torch.sparse.bsr import BSR

from _torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _check(A_sp, B_sp, **kw):
    """The reference test's _check for both packages, then the port's C
    against the reference's C block by block."""
    A, B = (BSR.from_scipy(A_sp, device="cpu"),
            BSR.from_scipy(B_sp, device="cpu"))
    C = port_mod.spgemm_bsr(A, B, **kw)
    got = C.to_scipy().tocsr()
    ref = (sps.csr_matrix(A.to_scipy()) @ sps.csr_matrix(B.to_scipy())
           ).tocsr()
    d = abs(got - ref)
    assert (d.max() if d.nnz else 0.0) < 1e-4 * max(abs(ref).max(), 1.0)
    R = ref_mod.spgemm_bsr(RefBSR.from_scipy(A_sp), RefBSR.from_scipy(B_sp),
                           **kw)
    assert C.shape == R.shape and C.blocks.dtype == torch.float32
    assert C.blocks.device.type == "cpu"           # a tensor, not numpy
    np.testing.assert_array_equal(C.indices.numpy(), np.asarray(R.indices))
    np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(R.indptr))
    want = np.asarray(R.blocks)
    np.testing.assert_allclose(C.blocks.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1.0))
    return C


@pytest.mark.parametrize("m,k,n,da,db", [
    (64, 64, 64, 0.1, 0.1),
    (200, 160, 240, 0.05, 0.08),      # non-multiple-of-8 shapes
    (1, 1, 1, 1.0, 1.0),              # reference edge-size style
    (111, 297, 113, 0.2, 0.2),
])
def test_spgemm_bsr_random(m, k, n, da, db):
    A = sps.random(m, k, density=da, random_state=1, format="csr",
                   dtype=np.float32)
    B = sps.random(k, n, density=db, random_state=2, format="csr",
                   dtype=np.float32)
    _check(A, B)


def test_spgemm_bsr_vpu_variant_exact():
    A = sps.random(128, 128, density=0.1, random_state=3, format="csr",
                   dtype=np.float32)
    C = _check(A, A, mxu=False)
    # the elementwise form and the bmm form compute the same blocks
    Ab = BSR.from_scipy(A, device="cpu")
    mm = port_mod.spgemm_bsr(Ab, Ab, mxu=True).blocks
    torch.testing.assert_close(C.blocks, mm, rtol=1e-6, atol=1e-6)


def test_spgemm_bsr_pair_chunking():
    """Chunk boundaries mid-segment must still sum exactly (partial
    segment sums add)."""
    A = poisson2d(24)  # 576x576, blocks straddle rows
    _check(A, A, pair_chunk=1000)


def test_spgemm_bsr_poisson_vs_scalar():
    """Block and scalar SpGEMM agree on the same product."""
    from libhpc_tpu_torch.ops.spgemm import spgemm_csr
    from libhpc_tpu_torch.sparse import CSR

    A = poisson2d(20)
    C_blk = port_mod.spgemm_bsr(BSR.from_scipy(A, device="cpu"),
                                BSR.from_scipy(A, device="cpu")).to_scipy()
    C_sc = spgemm_csr(CSR.from_scipy(A, device="cpu"),
                      CSR.from_scipy(A, device="cpu")).to_scipy()
    d = abs(C_blk.tocsr()[:400, :400] - C_sc.tocsr()[:400, :400])
    assert (d.max() if d.nnz else 0.0) < 1e-5


def test_spgemm_bsr_empty():
    A = sps.csr_matrix((64, 64), dtype=np.float32)
    B = sps.random(64, 64, density=0.1, random_state=4, format="csr",
                   dtype=np.float32)
    C = port_mod.spgemm_bsr(BSR.from_scipy(A, device="cpu"),
                            BSR.from_scipy(B, device="cpu"))
    R = ref_mod.spgemm_bsr(RefBSR.from_scipy(A), RefBSR.from_scipy(B))
    assert abs(C.to_scipy()).max() == 0.0
    assert C.blocks.shape == R.blocks.shape == (1, 8, 8)
    assert C.indptr.shape == R.indptr.shape


def test_spgemm_bsr_rectangular_blocks_mismatch():
    eye = sps.identity(64, format="csr", dtype=np.float32)
    A = BSR.from_scipy(eye, block=8, device="cpu")
    B = BSR.from_scipy(eye, block=4, device="cpu")
    with pytest.raises(ValueError, match="block size mismatch") as got:
        port_mod.spgemm_bsr(A, B)
    with pytest.raises(ValueError) as want:
        ref_mod.spgemm_bsr(RefBSR.from_scipy(eye, block=8),
                           RefBSR.from_scipy(eye, block=4))
    assert str(got.value) == str(want.value)


def test_spgemm_bsr_shape_mismatch():
    A = BSR.from_scipy(sps.identity(64, format="csr", dtype=np.float32),
                       device="cpu")
    B = BSR.from_scipy(sps.identity(32, format="csr", dtype=np.float32),
                       device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        port_mod.spgemm_bsr(A, B)


@pytest.mark.parametrize("m,k,n,da,db", [(64, 64, 64, 0.1, 0.1),
                                         (200, 160, 240, 0.05, 0.08),
                                         (1, 1, 1, 1.0, 1.0)])
def test_symbolic_equals_reference(m, k, n, da, db):
    """_symbolic's (ia, ib, seg, out_rows, out_cols) equal the
    reference's array by array."""
    A = BSR.from_scipy(sps.random(m, k, density=da, random_state=1,
                                  format="csr", dtype=np.float32),
                       device="cpu")
    B = BSR.from_scipy(sps.random(k, n, density=db, random_state=2,
                                  format="csr", dtype=np.float32),
                       device="cpu")
    args = [t.numpy().astype(np.int64) for t in (A.indices, A.indptr,
                                                 B.indices, B.indptr)]
    got = port_mod._symbolic(*args, B.shape[1] // 8)
    want = ref_mod._symbolic(*args, B.shape[1] // 8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_spgemm_bsr_integer_blocks():
    """Integer blocks are multiplied in float32 (never on bmm) and cast
    back to their dtype, as the reference does."""
    rs = np.random.RandomState(5)
    d = (rs.randint(-3, 4, (32, 32)) * (rs.rand(32, 32) < 0.3))
    A = sps.csr_matrix(d.astype(np.int32))
    C = port_mod.spgemm_bsr(BSR.from_scipy(A, device="cpu"),
                            BSR.from_scipy(A, device="cpu"))
    R = ref_mod.spgemm_bsr(RefBSR.from_scipy(A), RefBSR.from_scipy(A))
    assert C.blocks.dtype == torch.int32 == getattr(torch, str(
        np.asarray(R.blocks).dtype))
    np.testing.assert_array_equal(C.blocks.numpy(), np.asarray(R.blocks))
    np.testing.assert_array_equal(C.todense().numpy(), d @ d)


def test_spgemm_bsr_scipy_returns_the_bsr():
    A = poisson2d(8)
    C = port_mod.spgemm_bsr_scipy(A, A, device="cpu")
    R = ref_mod.spgemm_bsr_scipy(A, A)
    assert type(C).__name__ == type(R).__name__ == "BSR"
    np.testing.assert_allclose(C.todense().numpy(), (A @ A).toarray(),
                               rtol=1e-5, atol=1e-5)


def test_empty_product_applies_as_zero():
    """The empty product's one zero block lies past indptr[-1]: its SpMV
    and SpMM give zeros, as the reference's (whose segment sums drop it)."""
    from libhpc_tpu.ops import spmm as ref_spmm
    from libhpc_tpu.ops import spmv as ref_spmv
    from libhpc_tpu_torch.ops import spmm, spmv

    A = sps.csr_matrix((64, 64), dtype=np.float32)
    B = sps.random(64, 64, density=0.1, random_state=4, format="csr",
                   dtype=np.float32)
    C = port_mod.spgemm_bsr(BSR.from_scipy(A, device="cpu"),
                            BSR.from_scipy(B, device="cpu"))
    R = ref_mod.spgemm_bsr(RefBSR.from_scipy(A), RefBSR.from_scipy(B))
    x = np.linspace(-1, 1, 64).astype(np.float32)
    np.testing.assert_array_equal(spmv.bsr_spmv(C, torch.from_numpy(x)),
                                  np.asarray(ref_spmv.bsr_spmv(R, x)))
    X = np.stack([x, -x], axis=1)
    np.testing.assert_array_equal(spmm.bsr_spmm(C, torch.from_numpy(X)),
                                  np.asarray(ref_spmm.bsr_spmm(R, X)))
