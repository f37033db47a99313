"""The port's binding of the native host runtime (runtime/native.py)
against libhpc_tpu's, on the cases of the reference's tests/test_native.py:
the self-test, the arena pool, the MatrixMarket loader (against scipy's
reader at rtol 1e-5 / atol 1e-6), the host Morton encode (equal to the
reference's and to the port's utils/morton), and the bench loading path
through $LIBHPC_MATRIX_DIR.

The port builds the library into libhpc_tpu_torch/_build/native, apart
from the reference's native/build; these tests never call the reference's
binding, which builds there, so the two test files never run one `make`
at once. ``bench_counter`` is checked for a
finite positive result only: the reference test's ordering of two
host-timed counters is what made it flaky.
"""

import math
import os

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sps
import torch

from libhpc_tpu_torch.runtime import native

from _torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_builds_into_the_port_build_directory():
    so = native.build()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert so == os.path.join(pkg, "_build", "native", "libhpc_host.so")
    assert os.path.exists(so)
    assert native.get_lib() is native.get_lib()


def test_selftest():
    assert native.selftest() == 0


def test_pool_lifecycle():
    p = native.ArenaPool(page_size=4096)
    ptrs = [p.alloc(100) for _ in range(100)]
    assert all(ptr % 16 == 0 for ptr in ptrs)
    assert p.n_pages >= 1 and p.bytes_reserved >= 100 * 100
    big = p.alloc(1 << 16)
    assert p.free_large(big)
    p.reset()
    assert p.n_pages >= 1
    p.close()
    p.close()                                   # closing twice is harmless


def _mtx(tmp_path, kind, n=60):
    """A seeded n x n matrix written as `kind` MatrixMarket, and the CSR
    the loader must return (the reference test's cases)."""
    seed = {"symmetric": 1, "pattern": 2, "general": 3}[kind]
    A = sps.random(n, n, density=0.1, format="coo", dtype=np.float64,
                   random_state=np.random.RandomState(seed))
    path = str(tmp_path / f"{kind}.mtx")
    if kind == "symmetric":
        A = (A + A.T).tocoo()
        sio.mmwrite(path, sps.tril(A), symmetry="symmetric")
    elif kind == "pattern":
        A.data[:] = 1.0
        sio.mmwrite(path, A, field="pattern")
    else:
        sio.mmwrite(path, A)
    return path, A.tocsr()


@pytest.mark.parametrize("kind", ["general", "symmetric", "pattern"])
def test_mtx_loader(tmp_path, kind):
    path, expect = _mtx(tmp_path, kind)
    got = native.load_mtx_native(path)
    assert got.shape == expect.shape and got.dtype == np.float32
    assert got.indices.dtype == got.indptr.dtype == np.int32
    np.testing.assert_allclose(got.toarray(),
                               expect.toarray().astype(np.float32),
                               rtol=1e-5, atol=1e-6)


def test_mtx_loader_large_parallel(tmp_path):
    """Multi-chunk parse: enough lines that every pool thread gets a span;
    canonical CSR (sorted column indices a row)."""
    n = 2000
    A = sps.random(n, n, density=0.01, format="coo", dtype=np.float64,
                   random_state=np.random.RandomState(4))
    path = str(tmp_path / "big.mtx")
    sio.mmwrite(path, A)
    got = native.load_mtx_native(path, n_threads=4)
    expect = A.tocsr()
    assert got.nnz == expect.nnz
    np.testing.assert_allclose(got.toarray(),
                               expect.toarray().astype(np.float32),
                               rtol=1e-5, atol=1e-6)
    for r in range(0, n, 97):
        s, e = got.indptr[r], got.indptr[r + 1]
        assert (np.diff(got.indices[s:e]) > 0).all()


def test_mtx_loader_errors(tmp_path):
    with pytest.raises(IOError, match="failed to parse"):
        native.load_mtx_native(str(tmp_path / "missing.mtx"))


def test_load_mtx_falls_back_to_scipy(tmp_path, monkeypatch):
    """Without the native library, load_mtx reads the file with scipy (on
    the host), as the reference's does."""
    path, expect = _mtx(tmp_path, "general")

    def unavailable(*a, **k):
        raise native.NativeUnavailable("no toolchain")

    monkeypatch.setattr(native, "get_lib", unavailable)
    got = native.load_mtx(path)
    np.testing.assert_allclose(got.toarray(), expect.toarray())


def test_morton_host_matches_reference_and_port(rng):
    import jax.numpy as jnp

    from libhpc_tpu.utils.morton import morton2d_encode as ref_encode
    from libhpc_tpu_torch.utils.morton import morton2d_encode

    x = rng.integers(0, 1 << 16, 1000).astype(np.uint32)
    y = rng.integers(0, 1 << 16, 1000).astype(np.uint32)
    got = native.morton2d_encode_host(x, y)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(
        got, np.asarray(ref_encode(jnp.asarray(x), jnp.asarray(y))))
    port = morton2d_encode(torch.from_numpy(x.view(np.int32)).long(),
                           torch.from_numpy(y.view(np.int32)).long(),
                           device="cpu")
    np.testing.assert_array_equal(got, port.numpy())


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_bench_counter_is_finite_and_positive(kind):
    ns = native.bench_counter(kind, threads=2, iters=20_000)
    assert math.isfinite(ns) and ns > 0


def test_matrix_dir_bench_path_end_to_end(tmp_path, monkeypatch):
    """A real .mtx under $LIBHPC_MATRIX_DIR flows through the port's
    load_or_synthesize -> native loader -> the SBELL SpMV (CPU), bit-
    identical across thread counts, instead of the synthetic stand-in."""
    from libhpc_tpu_torch.bench import matrices
    from libhpc_tpu_torch.ops.spmv_sbell import sbell_spmv
    from libhpc_tpu_torch.sparse.sbell import SBELL

    n = 400
    A = sps.random(n, n, density=0.05, format="coo", dtype=np.float64,
                   random_state=np.random.RandomState(11))
    A.setdiag(2.0)
    sio.mmwrite(str(tmp_path / "cant.mtx"), A)
    monkeypatch.setenv("LIBHPC_MATRIX_DIR", str(tmp_path))

    got = matrices.load_or_synthesize("cant")
    assert got.shape == (n, n)          # the file, not the 62k stand-in
    assert got.dtype == np.float32      # the native loader's, not scipy's
    expect = A.tocsr().astype(np.float32)
    np.testing.assert_allclose(got.toarray(), expect.toarray(),
                               rtol=1e-5, atol=1e-6)

    g1 = native.load_mtx_native(str(tmp_path / "cant.mtx"), n_threads=1)
    g4 = native.load_mtx_native(str(tmp_path / "cant.mtx"), n_threads=4)
    assert (g1.indptr == g4.indptr).all()
    assert (g1.indices == g4.indices).all()
    np.testing.assert_array_equal(g1.data, g4.data)

    sb = SBELL.from_scipy(got, device="cpu")
    x = np.linspace(-1, 1, n).astype(np.float32)
    y = sbell_spmv(sb, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, got @ x, rtol=1e-4, atol=1e-5)
