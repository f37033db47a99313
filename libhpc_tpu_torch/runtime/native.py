"""ctypes binding of the native host runtime (``native/``).

Port of ``libhpc_tpu/runtime/native.py``: the same framework-free C++
library (arena pool, thread pool, MPMC queue, parallel MatrixMarket
loader, host Morton encode, the concurrency self-test) and the same C API;
no C++ is copied. ``build()`` compiles it on first use with the repo's own
Makefile into the port's build directory,

    make -C native BUILD=<repo>/libhpc_tpu_torch/_build/native all

never into ``native/build/``, so the reference's build and the port's
never share a ``make``; a file lock around the build keeps two processes
of the port from running it at once. ``load_mtx`` keeps the reference's
scipy fallback (host parsing only) for a machine without a toolchain.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
_BUILD_DIR = os.path.join(_PKG, "_build", "native")
_SO_PATH = os.path.join(_BUILD_DIR, "libhpc_host.so")

_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def build(force: bool = False) -> str:
    """Compile the native library (cached). Returns the .so path."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if force or not os.path.exists(_SO_PATH):
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, f"BUILD={_BUILD_DIR}", "all"],
                check=True, capture_output=True)
    return _SO_PATH


def get_lib(build_if_missing: bool = True):
    """Load (building if needed) the native library; raises
    NativeUnavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            if build_if_missing:
                build()
            lib = ctypes.CDLL(_SO_PATH)
        except (OSError, subprocess.CalledProcessError) as e:
            raise NativeUnavailable(str(e)) from e

        c = ctypes
        lib.hpc_pool_create.restype = c.c_void_p
        lib.hpc_pool_create.argtypes = [c.c_size_t]
        lib.hpc_pool_alloc.restype = c.c_void_p
        lib.hpc_pool_alloc.argtypes = [c.c_void_p, c.c_size_t]
        lib.hpc_pool_free_large.restype = c.c_int
        lib.hpc_pool_free_large.argtypes = [c.c_void_p, c.c_void_p]
        lib.hpc_pool_reset.restype = None
        lib.hpc_pool_reset.argtypes = [c.c_void_p]
        lib.hpc_pool_destroy.restype = None
        lib.hpc_pool_destroy.argtypes = [c.c_void_p]
        lib.hpc_pool_bytes_reserved.restype = c.c_size_t
        lib.hpc_pool_bytes_reserved.argtypes = [c.c_void_p]
        lib.hpc_pool_n_pages.restype = c.c_size_t
        lib.hpc_pool_n_pages.argtypes = [c.c_void_p]

        lib.hpc_threadpool_create.restype = c.c_void_p
        lib.hpc_threadpool_create.argtypes = [c.c_int]
        lib.hpc_threadpool_size.restype = c.c_int
        lib.hpc_threadpool_size.argtypes = [c.c_void_p]
        lib.hpc_threadpool_destroy.restype = None
        lib.hpc_threadpool_destroy.argtypes = [c.c_void_p]

        lib.hpc_mtx_open.restype = c.c_void_p
        lib.hpc_mtx_open.argtypes = [c.c_char_p, c.c_int]
        lib.hpc_mtx_rows.restype = c.c_int64
        lib.hpc_mtx_rows.argtypes = [c.c_void_p]
        lib.hpc_mtx_cols.restype = c.c_int64
        lib.hpc_mtx_cols.argtypes = [c.c_void_p]
        lib.hpc_mtx_nnz.restype = c.c_int64
        lib.hpc_mtx_nnz.argtypes = [c.c_void_p]
        lib.hpc_mtx_fill_csr.restype = c.c_int
        lib.hpc_mtx_fill_csr.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                         c.c_void_p]
        lib.hpc_mtx_close.restype = None
        lib.hpc_mtx_close.argtypes = [c.c_void_p]

        lib.hpc_morton2d_encode.restype = None
        lib.hpc_morton2d_encode.argtypes = [c.c_void_p, c.c_void_p,
                                            c.c_void_p, c.c_int64]
        lib.hpc_native_selftest.restype = c.c_int
        lib.hpc_native_selftest.argtypes = []
        lib.hpc_bench_counter.restype = c.c_double
        lib.hpc_bench_counter.argtypes = [c.c_int, c.c_int, c.c_int]

        _lib = lib
        return _lib


class ArenaPool:
    """Python handle to the native arena pool (libHPC's mempool)."""

    def __init__(self, page_size: int = 4096):
        self._lib = get_lib()
        self._h = self._lib.hpc_pool_create(page_size)
        if not self._h:
            raise MemoryError("pool create failed")

    def alloc(self, size: int) -> int:
        p = self._lib.hpc_pool_alloc(self._h, size)
        if not p:
            raise MemoryError("pool alloc failed")
        return p

    def free_large(self, ptr: int) -> bool:
        return bool(self._lib.hpc_pool_free_large(self._h, ptr))

    def reset(self):
        self._lib.hpc_pool_reset(self._h)

    @property
    def bytes_reserved(self) -> int:
        return self._lib.hpc_pool_bytes_reserved(self._h)

    @property
    def n_pages(self) -> int:
        return self._lib.hpc_pool_n_pages(self._h)

    def close(self):
        if self._h:
            self._lib.hpc_pool_destroy(self._h)
            self._h = None

    def __del__(self):
        # a pool that failed in __init__ has no handle; at interpreter
        # exit the library may be gone
        if getattr(self, "_h", None):
            self.close()


def load_mtx_native(path: str, n_threads: int = 0):
    """Parallel-parse a MatrixMarket file -> scipy CSR (float32 values,
    int32 indices), on the host."""
    import scipy.sparse as sps

    lib = get_lib()
    h = lib.hpc_mtx_open(path.encode(), n_threads)
    if not h:
        raise IOError(f"failed to parse {path}")
    try:
        nr = lib.hpc_mtx_rows(h)
        nc = lib.hpc_mtx_cols(h)
        nnz = lib.hpc_mtx_nnz(h)
        indptr = np.zeros(nr + 1, np.int32)
        indices = np.zeros(nnz, np.int32)
        data = np.zeros(nnz, np.float32)
        rc = lib.hpc_mtx_fill_csr(
            h,
            indptr.ctypes.data_as(ctypes.c_void_p),
            indices.ctypes.data_as(ctypes.c_void_p),
            data.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise IOError(f"csr build failed rc={rc}")
    finally:
        lib.hpc_mtx_close(h)
    return sps.csr_matrix((data, indices, indptr), shape=(nr, nc))


def load_mtx(path: str):
    """MatrixMarket loader: native fast path, scipy fallback (host)."""
    try:
        return load_mtx_native(path)
    except NativeUnavailable:
        import scipy.io as sio

        return sio.mmread(path).tocsr()


def morton2d_encode_host(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.uint32)
    y = np.ascontiguousarray(y, np.uint32)
    if x.shape != y.shape:
        raise ValueError(f"x {x.shape} and y {y.shape} differ in shape")
    out = np.zeros_like(x)
    get_lib().hpc_morton2d_encode(
        x.ctypes.data_as(ctypes.c_void_p), y.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), x.size,
    )
    return out


def selftest() -> int:
    """Run the native concurrency/pool stress self-test; 0 = pass."""
    return get_lib().hpc_native_selftest()


def bench_counter(kind: int, threads: int = 4,
                  iters: int = 1_000_000) -> float:
    """ns per increment for kind: 0=unsync, 1=atomic, 2=mutex, 3=CAS:
    libHPC's counter-cost sweep (test_hpc_benchmark.cpp:1067-1126)."""
    return float(get_lib().hpc_bench_counter(kind, threads, iters))
