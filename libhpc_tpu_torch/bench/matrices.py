"""Benchmark matrix generators.

Port of ``libhpc_tpu/bench/matrices.py``, numpy/scipy as is: `cant` and
`pwtk` are modeled by deterministic synthetic stand-ins with the same
structural statistics (size, nnz/row, block structure), so both packages
build bit-identical matrices from the same seed. If real .mtx files are
present under $LIBHPC_MATRIX_DIR they are read by the native loader
(``runtime/native.py``), or by scipy.io.mmread where the native library
cannot be built or cannot parse the file, as the reference reads them.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sps


def poisson2d(n: int, dtype=np.float32) -> sps.csr_matrix:
    """5-point Poisson on an n×n grid."""
    d = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    I = sps.identity(n)
    return (sps.kron(I, d) + sps.kron(d, I)).tocsr().astype(dtype)


def poisson3d(n: int, dtype=np.float32) -> sps.csr_matrix:
    d = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    I = sps.identity(n)
    A = (
        sps.kron(sps.kron(I, I), d)
        + sps.kron(sps.kron(I, d), I)
        + sps.kron(sps.kron(d, I), I)
    )
    return A.tocsr().astype(dtype)


def block_random(n_block_rows: int, block: int = 8,
                 blocks_per_row: int = 8, seed: int = 0,
                 half_band: int = 4, far_fraction: float = 0.02,
                 dtype=np.float32) -> sps.csr_matrix:
    """Synthetic FEM-like matrix: dense b×b blocks clustered in a band of
    ±half_band block-columns around the diagonal, plus a small
    `far_fraction` of uniformly random block columns (constraint-style
    long-range couplings). Stand-in generator for cant/pwtk structure."""
    rs = np.random.RandomState(seed)
    n = n_block_rows * block
    n_far_rows = max(1, int(far_fraction * n_block_rows * blocks_per_row))
    far_rows = set(rs.randint(0, n_block_rows, size=n_far_rows))
    # the reference's draws in the reference's order (a row's offsets, its
    # far column, then one randn(b*b) a block, which equal one randn over
    # the row's blocks); the entries are laid out at once afterwards
    bcols, vals = [], []
    for br in range(n_block_rows):
        near = br + rs.randint(-half_band, half_band + 1,
                               size=blocks_per_row - 1)
        extra = (rs.randint(0, n_block_rows, size=1)
                 if br in far_rows else np.empty(0, np.int64))
        bcs = np.unique(np.clip(np.concatenate([near, extra, [br]]), 0,
                                n_block_rows - 1))
        bcols.append(bcs)
        vals.append(rs.randn(bcs.size * block * block).astype(dtype))
    bc = np.concatenate(bcols).astype(np.int64)
    br = np.repeat(np.arange(n_block_rows, dtype=np.int64),
                   [c.size for c in bcols])
    # entry (i, j) of a block at i * block + j, as meshgrid(..., "ij")
    ii = np.repeat(np.arange(block), block)
    jj = np.tile(np.arange(block), block)
    A = sps.coo_matrix(
        (np.concatenate(vals),
         (((br * block)[:, None] + ii).ravel(),
          ((bc * block)[:, None] + jj).ravel())),
        shape=(n, n),
    ).tocsr()
    A.sum_duplicates()
    return A


def block_random_fast(n_block_rows: int, block: int = 8,
                      blocks_per_row: int = 8, seed: int = 0,
                      half_band: int = 6, far_fraction: float = 0.02,
                      dtype=np.float32) -> sps.csr_matrix:
    """Vectorized block_random for 100M-nnz-class matrices. Same structural
    statistics: dense b×b blocks in a ±half_band block-column band plus a
    far_fraction tail of random long-range blocks; duplicate block columns
    are summed by the CSR conversion."""
    rs = np.random.RandomState(seed)
    nbr = n_block_rows
    b = block
    br = np.arange(nbr, dtype=np.int64)
    offs = rs.randint(-half_band, half_band + 1,
                      size=(nbr, blocks_per_row - 1))
    cols = np.concatenate([br[:, None], br[:, None] + offs], axis=1)
    np.clip(cols, 0, nbr - 1, out=cols)
    n_far = int(far_fraction * nbr * blocks_per_row)
    if n_far:
        fr = rs.randint(0, nbr, size=n_far)
        fc = rs.randint(0, blocks_per_row, size=n_far)
        cols[fr, fc] = rs.randint(0, nbr, size=n_far)
    data = rs.standard_normal(
        (nbr * blocks_per_row, b, b)).astype(dtype)
    indptr = np.arange(nbr + 1, dtype=np.int64) * blocks_per_row
    cols.sort(axis=1)
    A = sps.bsr_matrix((data, cols.reshape(-1), indptr),
                       shape=(nbr * b, nbr * b)).tocsr()
    A.sum_duplicates()
    return A


def cant_like(dtype=np.float32) -> sps.csr_matrix:
    """Stand-in for SuiteSparse `cant` (FEM cantilever: 62k rows, ~4M nnz,
    ~64 nnz/row in 8-ish blocks, tightly banded mesh connectivity)."""
    return block_random(62_000 // 8, block=8, blocks_per_row=8, seed=1,
                        half_band=6, far_fraction=0.02, dtype=dtype)


def pwtk_like(dtype=np.float32) -> sps.csr_matrix:
    """Stand-in for SuiteSparse `pwtk` (wind tunnel: 218k rows, ~11.5M nnz,
    wider FEM band than cant)."""
    return block_random(218_000 // 8, block=8, blocks_per_row=7, seed=2,
                        half_band=40, far_fraction=0.02, dtype=dtype)


def load_or_synthesize(name: str) -> sps.csr_matrix:
    """Load $LIBHPC_MATRIX_DIR/<name>.mtx if present, else synthesize."""
    mdir = os.environ.get("LIBHPC_MATRIX_DIR", "")
    path = os.path.join(mdir, f"{name}.mtx") if mdir else ""
    if path and os.path.exists(path):
        from libhpc_tpu_torch.runtime import native

        try:
            return native.load_mtx_native(path)
        except (native.NativeUnavailable, OSError):
            import scipy.io as sio

            return sio.mmread(path).tocsr()
    gen = {"cant": cant_like, "pwtk": pwtk_like}
    if name in gen:
        return gen[name]()
    raise KeyError(name)
