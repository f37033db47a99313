"""Micro-benchmark corpus: libHPC's google-benchmark workload suite
(tests/test_hpc_benchmark/test_hpc_benchmark.cpp) on the card, with this
library's sort, scan, SpMV and solver paths beside it.

Port of ``libhpc_tpu/bench/corpus.py``: the same benches, ``ALL`` keys,
record names and JSON keys. Streams, layouts, access patterns, dtypes, the
matmul and the convolution are plain torch ops, as the reference's are
plain XLA ops; the transpose, blur, sort, scan, histogram and SBELL benches
launch the port's hand-written kernels (K17, K19, K8-K10, K13, K15,
K1-K3).

    python -m libhpc_tpu_torch.bench.corpus [name ...]

prints one JSON line a record: ``{"bench": ..., "ms": ..., ...}``. Timings
are the delta method of ``bench/harness.py`` (chains of CUDA launches
timed by CUDA events); ``time_iterated`` below keeps the best of two
plausible readings. Every ``bench_*`` takes ``device="cuda"`` and keyword
sizes whose defaults are the reference's; smaller sizes exist for tests.

Records that differ from the reference's, on purpose:

- ``spmv_sbell_100m_chunked`` has no ``chunked``, ``n_chunks``,
  ``resident_mb`` or ``vmem_cap_mb``: they describe the reference's TPU
  VMEM chunk plan, and the card's SpMV kernel reads x from device memory
  in one fused launch whatever the size. It adds ``launches``, the fused
  SpMV launches of one matvec (1 on the card, 0 on the CPU, where the
  plain version runs). The name stays the reference's.
- ``cg_sbell_cant_32it`` adds ``iters_run``, the CG iterations that each
  timed step ran: cant_like is not SPD, and CG breaks down (``rs`` NaN ends
  the loop) after 8 of the 32 iterations the name says. ``iters_per_s``
  and ``gnnz_per_s`` count the iterations that ran, where the reference
  counts 32. The step's next right-hand side takes the iterate with its
  non-finite entries as 0, so every step solves the same finite system
  and runs the same iterations (the reference's ``v + x * 1e-30`` would
  carry the NaN iterate into b, and the later steps would run none).

Call-site rules the reference did not need:

- float32 operators: ``A + I/2`` from scipy is float64, and the port's
  containers keep a float64 input as float64 (the reference stores float32
  because it runs without x64), so the shifted Poisson system is cast to
  float32 before it becomes a DIA, and the DIA's dtype is asserted.
- uint32: torch's uint32 is a storage dtype on the card (roll and index do
  not take it everywhere), so the sort steps roll the int32 view and the
  Morton decode's uint32 codes become int64 indices before they gather.

``main`` prints an error record for a bench that raises, as the
reference's does, runs the rest, and then raises: a failed bench fails
the run.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
import traceback

import numpy as np
import torch

from libhpc_tpu_torch.bench import harness, matrices

# bench -> the records it prints, in order (the reference's names)
RECORDS = {
    "stream": ("stream_mul_128MB",),
    "layout": ("layout_aos_32M", "layout_soa_32M", "layout_aosoa_32M"),
    "transpose": ("transpose_xla_8k", "transpose_pallas_8k",
                  "transpose_morton_8k"),
    "matmul": ("matmul_f32_1024", "matmul_bf16_1024", "matmul_f32_8192",
               "matmul_bf16_8192"),
    "conv": ("conv2d_1024_k16",),
    "blur": ("blur2d_xla_8192_r8", "blur2d_pallas_8192_r8"),
    "sort": ("sort_u32_10M", "merge_sort_10M", "merge_sort_100M",
             "radix_pipeline_1M"),
    "scan_hist": ("exclusive_scan_pallas_4M", "histogram_pallas_4M"),
    "spmv": ("spmv_dia_poisson512", "spmv_ell_poisson512"),
    "sbell": ("spmv_sbell_cant", "spmv_sbell_cant_bf16", "spmv_sbell_pwtk",
              "spmv_sbell_pwtk_bf16"),
    "spmm_cg": ("spmm_ell_poisson512_k64", "spmm_bsr_cant_k64",
                "cg_dia_poisson512s_32it", "cg_sbell_cant_32it"),
    "scale": ("spmv_sbell_100m_chunked", "spgemm_windowed_pwtk_10m"),
    "amg": ("amg_vcycle_cant_spd",),
    "particles": ("particle_writes_1M", "particle_writes_dense_1M"),
    "access": ("access_sequential_128MB", "access_random_16MB"),
    "dtypes": ("dtype_stream_f32_128M", "dtype_stream_bf16_128M",
               "dtype_stream_i8_128M"),
}

# the records whose oracle gate sets "correct": true
GATED = ("spmv_sbell_cant_bf16", "spmv_sbell_pwtk_bf16",
         "spmm_ell_poisson512_k64", "spmm_bsr_cant_k64",
         "cg_dia_poisson512s_32it", "cg_sbell_cant_32it",
         "spmv_sbell_100m_chunked", "spgemm_windowed_pwtk_10m",
         "amg_vcycle_cant_spd")

MATMUL_SIZES = (1024, 8192)   # the sizes in the matmul records' names


def time_iterated(fn, x0, **kw):
    """harness.time_iterated, keeping the best of two plausible readings
    (a reading the card's neighbours slowed only inflates); a reading of
    <= 0.2 us is no reading, and after four tries without one the result
    is NaN, which _emit reports as an error."""
    best = float("inf")
    good = 0
    for _ in range(4):
        per = harness.time_iterated(fn, x0, **kw)
        if per > 2e-7:
            best = min(best, per)
            good += 1
            if good >= 2:
                return best
    return best if best < float("inf") else float("nan")


def _emit(name: str, per_s: float, **extra):
    if not (per_s > 2e-7):  # collapsed/NaN reading: refuse to report
        print(json.dumps({"bench": name,
                          "error": "no plausible reading"}), flush=True)
        return
    d = {"bench": name, "ms": round(per_s * 1e3, 4)}
    d.update({k: (round(v, 3) if isinstance(v, float) else v)
              for k, v in extra.items()})
    print(json.dumps(d), flush=True)


def _error(name: str) -> None:
    print(json.dumps({"bench": name, "error": "incorrect result"}),
          flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@contextlib.contextmanager
def _no_tf32():
    """Full float32 in cuBLAS and cuDNN (torch's cuDNN flag defaults to
    TF32), as XLA's float32 products; the flags are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _roll1(s: torch.Tensor) -> torch.Tensor:
    """Roll sorted uint32 keys by one, through their int32 view, so the
    next iteration sorts again."""
    return torch.roll(s.view(torch.int32), 1).view(torch.uint32)


def _u32_keys(rng, n: int, device) -> torch.Tensor:
    """n uniform u32 keys drawn by numpy, as a uint32 view on `device`."""
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    return torch.from_numpy(keys.view(np.int32)).to(device).view(torch.uint32)


def bench_stream(n: int = 1 << 25, device="cuda"):
    x = torch.full((n,), 1.0, dtype=torch.float32, device=device)
    per = time_iterated(lambda v: v * 1.0000001, x, iters=128, iters_small=16)
    _emit("stream_mul_128MB", per, gb_per_s=2 * n * 4 / per / 1e9)


def morton_transpose_fn(n: int, tile: int = 256, device="cuda"):
    """The reference's libmorton transpose (test_hpc_benchmark.cpp:705-750)
    of an (n, n) matrix: its (tile, tile) tiles visited in Z order, each
    transposed and stored at the mirrored tile. Returns the step."""
    from libhpc_tpu_torch.utils.morton import morton2d_decode

    nt = n // tile
    code = torch.arange(nt * nt, dtype=torch.int64, device=device)
    ty, tx = (c.view(torch.int32).to(torch.int64)
              for c in morton2d_decode(code, device=device))

    def morton_transpose(v):
        tiles = v.reshape(nt, tile, nt, tile).permute(0, 2, 1, 3)
        g = tiles[ty, tx]                       # Z-ordered tile stream
        out = v.new_zeros((nt, nt, tile, tile))
        out[tx, ty] = g.transpose(1, 2)         # per-tile transpose
        return out.permute(0, 2, 1, 3).reshape(n, n) + 0.0

    return morton_transpose


def bench_transpose(n: int = 8192, tile: int = 256, device="cuda"):
    from libhpc_tpu_torch.ops.transpose import transpose_pallas

    x = torch.ones((n, n), dtype=torch.float32, device=device)
    nbytes = x.numel() * 4
    per = time_iterated(lambda v: v.t().contiguous(), x, iters=16,
                        iters_small=2)
    _emit("transpose_xla_8k", per, gb_per_s=2 * nbytes / per / 1e9)
    per = time_iterated(transpose_pallas, x, iters=16, iters_small=2)
    _emit("transpose_pallas_8k", per, gb_per_s=2 * nbytes / per / 1e9)
    per = time_iterated(morton_transpose_fn(n, tile, device), x, iters=8,
                        iters_small=2)
    _emit("transpose_morton_8k", per, gb_per_s=2 * nbytes / per / 1e9)


def bench_matmul(sizes: tuple = MATMUL_SIZES, device="cuda"):
    """Reference scale: 1024x1024 blocked matmul
    (test_hpc_benchmark.cpp:758); torch.matmul (cuBLAS), full float32."""
    with _no_tf32():
        for label, n in zip(MATMUL_SIZES, sizes):
            a = torch.ones((n, n), dtype=torch.float32, device=device)
            per = time_iterated(lambda v: (v @ v) * 1e-3, a, iters=16,
                                iters_small=2)
            _emit(f"matmul_f32_{label}", per, tflops=2 * n ** 3 / per / 1e12)
            ab = a.to(torch.bfloat16)
            per = time_iterated(lambda v: (v @ v) * 1e-3, ab, iters=16,
                                iters_small=2)
            _emit(f"matmul_bf16_{label}", per,
                  tflops=2 * n ** 3 / per / 1e12)


def bench_conv(n: int = 1024, k: int = 16, device="cuda"):
    """Reference scale: 1024^2 image, 16x16 kernel
    (test_hpc_benchmark.cpp:793); SAME padding (k - 1 split low 7, high
    8, as XLA's), cuDNN in full float32."""
    import torch.nn.functional as F

    img = torch.ones((1, 1, n, n), dtype=torch.float32, device=device)
    ker = torch.ones((1, 1, k, k), dtype=torch.float32, device=device)

    def conv(v):
        return v * 0.5 + F.conv2d(v, ker, padding="same") * 1e-3

    with _no_tf32():
        per = time_iterated(conv, img, iters=8, iters_small=2)
    _emit("conv2d_1024_k16", per, gflops=2 * n * n * k * k / per / 1e9)


def bench_blur(n: int = 8192, radius: int = 8, device="cuda"):
    """Reference scale: 8192^2, radius 8 (test_hpc_benchmark.cpp:29-33)."""
    from libhpc_tpu_torch.ops.stencil import blur2d, blur2d_pallas

    a = torch.ones((n, n), dtype=torch.float32, device=device)
    nbytes = a.numel() * 4
    per = time_iterated(lambda v: blur2d(v, radius) * 0.0588 / 17.0 + 0.0,
                        a, iters=8, iters_small=2)
    _emit("blur2d_xla_8192_r8", per, gb_per_s=2 * nbytes / per / 1e9)
    per = time_iterated(lambda v: blur2d_pallas(v, radius) * 0.0588 / 17.0,
                        a, iters=8, iters_small=2)
    _emit("blur2d_pallas_8192_r8", per, gb_per_s=2 * nbytes / per / 1e9)


def bench_sort(n: int = 10_000_000, n_large: int = 100_000_000,
               n_radix: int = 1_000_000, device="cuda"):
    """Reference CPU-test scale: 10M uint32 (test_radixsort_v1.cc); the
    reference GPU gtest's 100M; the radix pipeline at 1M."""
    from libhpc_tpu_torch.ops.sort import radix_sort_pipeline, sort_u32
    from libhpc_tpu_torch.ops.sort_merge import merge_sort_u32

    rng = np.random.default_rng(0)
    x = _u32_keys(rng, n, device)
    per = time_iterated(lambda v: _roll1(sort_u32(v)), x, iters=8,
                        iters_small=2)
    _emit("sort_u32_10M", per, gelem_per_s=n / per / 1e9)
    per = time_iterated(lambda v: _roll1(merge_sort_u32(v)), x, iters=8,
                        iters_small=2)
    _emit("merge_sort_10M", per, gelem_per_s=n / per / 1e9)
    del x

    x100 = _u32_keys(rng, n_large, device)
    per = time_iterated(lambda v: _roll1(merge_sort_u32(v)), x100,
                        iters=3, iters_small=1)
    _emit("merge_sort_100M", per, gelem_per_s=n_large / per / 1e9)
    del x100

    x1 = _u32_keys(rng, n_radix, device)
    per = time_iterated(lambda v: _roll1(radix_sort_pipeline(v)), x1,
                        iters=3, iters_small=1)
    _emit("radix_pipeline_1M", per, gelem_per_s=n_radix / per / 1e9)


def bench_scan_hist(n: int = 1 << 22, device="cuda"):
    from libhpc_tpu_torch.ops.histogram import histogram_pallas
    from libhpc_tpu_torch.ops.scan import exclusive_scan_pallas

    x = torch.ones((n,), dtype=torch.float32, device=device)
    per = time_iterated(lambda v: exclusive_scan_pallas(v) * 1e-9, x,
                        iters=8, iters_small=2)
    _emit("exclusive_scan_pallas_4M", per, gb_per_s=2 * n * 4 / per / 1e9)

    xi = torch.zeros((n,), dtype=torch.int32, device=device)

    def hstep(v):
        # h[0] & 1 is 0 but depends on the histogram, so each step needs it
        return v + (histogram_pallas(v, 256)[0] & 1)

    per = time_iterated(hstep, xi, iters=8, iters_small=2)
    _emit("histogram_pallas_4M", per, gelem_per_s=n / per / 1e9)


def bench_spmv(grid: int = 512, device="cuda"):
    from libhpc_tpu_torch.ops import spmv
    from libhpc_tpu_torch.sparse import CSR, DIA, ELL

    A = matrices.poisson2d(grid)  # 262k rows, 1.3M nnz at 512
    csr = CSR.from_scipy(A, device=device)
    nnz = A.nnz
    x = torch.ones((A.shape[0],), dtype=torch.float32, device=device)
    dia = DIA.from_scipy(A, device=device)
    per = time_iterated(lambda v: spmv.dia_spmv(dia, v), x, iters=32,
                        iters_small=4)
    _emit("spmv_dia_poisson512", per, gnnz_per_s=nnz / per / 1e9)
    ell = ELL.from_csr(csr)
    per = time_iterated(lambda v: spmv.ell_spmv(ell, v), x, iters=8,
                        iters_small=2)
    _emit("spmv_ell_poisson512", per, gnnz_per_s=nnz / per / 1e9)


def bf16_gate(A, sb16, device="cuda"):
    """The bf16 SpMV's gate: sbell_spmv of the bf16 SBELL against scipy on
    the bf16-QUANTIZED operator (the kernel accumulates in float32), at
    rtol = atol = 2e-3. Returns (ok, y16, the quantized scipy matrix)."""
    from libhpc_tpu_torch.ops.spmv_sbell import sbell_spmv

    xf = np.linspace(-1, 1, A.shape[1], dtype=np.float32)
    Aq = A.copy()
    Aq.data = torch.from_numpy(np.asarray(A.data, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()
    y16 = _np(sbell_spmv(sb16, torch.from_numpy(xf).to(device)))
    return np.allclose(y16, Aq @ xf, rtol=2e-3, atol=2e-3), y16, Aq


def bench_sbell(device="cuda"):
    """The SBELL SpMV (K1-K3, one fused launch a matvec on the card) on
    cant_like and pwtk_like, float32 and bfloat16 values, with the
    fraction of the byte model's speed of light reached
    (tests/test_gpu_benchmark/test_gpu_benchmark.cpp:12,96-126)."""
    from libhpc_tpu_torch.ops.spmv_sbell import sbell_spmv_panes, x_to_panes
    from libhpc_tpu_torch.sparse.sbell import SBELL

    hbm = harness.measure_hbm_bandwidth(device=device)
    hbm_r = harness.measure_hbm_read_bandwidth(device=device)
    for name in ("cant", "pwtk"):
        A = matrices.load_or_synthesize(name)
        m, n = A.shape
        sb = SBELL.from_scipy(A, device=device)
        x = x_to_panes(sb, torch.from_numpy(np.linspace(
            -1, 1, sb.n_panes * 1024, dtype=np.float32)).to(device))
        rd, wr = harness.format_spmv_rw_bytes("sbell", sb, m, n)
        sol = harness.mixed_speed_of_light(hbm_r, hbm, rd, wr)
        nbytes = rd + wr
        per = time_iterated(lambda v: sbell_spmv_panes(sb, v), x,
                            iters=64, iters_small=8)
        _emit(f"spmv_sbell_{name}", per, gnnz_per_s=A.nnz / per / 1e9,
              own_bytes_fraction=nbytes / per / sol,
              hbm_gb_per_s=hbm / 1e9, sol_gb_per_s=sol / 1e9)

        sb16 = sb.astype_values(torch.bfloat16)
        if not bf16_gate(A, sb16, device)[0]:
            _error(f"spmv_sbell_{name}_bf16")
            continue
        rd16, wr16 = harness.format_spmv_rw_bytes("sbell", sb16, m, n)
        sol16 = harness.mixed_speed_of_light(hbm_r, hbm, rd16, wr16)
        nbytes16 = rd16 + wr16
        per = time_iterated(lambda v: sbell_spmv_panes(sb16, v), x,
                            iters=64, iters_small=8)
        _emit(f"spmv_sbell_{name}_bf16", per,
              gnnz_per_s=A.nnz / per / 1e9,
              own_bytes_fraction=nbytes16 / per / sol16,
              speedup_vs_f32_bytes=nbytes / nbytes16, correct=True)


def shifted_dia(A, device="cuda"):
    """(A + I/2 in float64 scipy, for the gate; its float32 DIA, for the
    solve): the shifted Poisson system of cg_dia_poisson512s_32it."""
    import scipy.sparse as sps

    from libhpc_tpu_torch.sparse import DIA

    A_sh = (A + sps.eye(A.shape[0]) * 0.5).tocsr()
    D = DIA.from_scipy(A_sh.astype(np.float32), device=device)
    if D.data.dtype != torch.float32:
        raise TypeError(f"shifted DIA holds {D.data.dtype}; the workload "
                        "is float32")
    return A_sh, D


def cg_fixed(matvec, b, n_it: int):
    """CG at tol 0 for n_it iterations (fewer only where rs turns NaN):
    (x, iterations run)."""
    from libhpc_tpu_torch.ops import solver

    x, it, _ = solver.cg(matvec, b, tol=0.0, max_iter=n_it)
    return x, it


def pane_cg(sb, b3, n_it: int):
    """cg_fixed entirely in the SBELL's pane layout (axpy and dot are
    elementwise, so CG is layout-oblivious): the chained form solvers
    run."""
    from libhpc_tpu_torch.ops.spmv_sbell import sbell_spmv_panes

    return cg_fixed(lambda u: sbell_spmv_panes(sb, u), b3, n_it)


def _emit_cg(name: str, per: float, ran: list, nnz: int,
             iters_run: bool = False):
    """A CG record whose rates count the iterations every timed step ran
    (``ran``: one count a step), with ``iters_run`` if asked; an error
    record where a step ran none or the steps differ, since the time is
    then not that of one count."""
    if not ran or ran[0] < 1 or min(ran) != max(ran):
        print(json.dumps({"bench": name, "error": f"timed steps ran "
                          f"{sorted(set(ran))} iterations"}), flush=True)
        return
    extra = {"iters_run": ran[0]} if iters_run else {}
    _emit(name, per, iters_per_s=ran[0] / per,
          gnnz_per_s=ran[0] * nnz / per / 1e9, **extra, correct=True)


def bench_spmm_cg(grid: int = 512, device="cuda"):
    """SpMM (sparse x 64-column dense) and a fixed 32-iteration CG loop on
    Poisson and cant_like (test_hpc_benchmark.cpp:758-784); each timed
    path is gated on an oracle first."""
    from libhpc_tpu_torch.ops import spmv
    from libhpc_tpu_torch.ops.spmm import bsr_spmm, ell_spmm
    from libhpc_tpu_torch.ops.spmv_sbell import (panes_to_x, sbell_spmv_panes,
                                                 x_to_panes)
    from libhpc_tpu_torch.sparse import BSR, CSR, ELL
    from libhpc_tpu_torch.sparse.sbell import SBELL

    hbm = harness.measure_hbm_bandwidth(device=device)
    K = 64
    rng = np.random.default_rng(7)

    # SpMM: Poisson through ELL (structured), cant through BSR (FEM blocks)
    A = matrices.poisson2d(grid)
    ell = ELL.from_csr(CSR.from_scipy(A, device=device))
    Xn = rng.standard_normal((A.shape[1], K)).astype(np.float32)
    X = torch.from_numpy(Xn).to(device)
    okm = np.allclose(_np(ell_spmm(ell, X)), A @ Xn, rtol=2e-3, atol=2e-3)
    # own bytes: stored values and columns once, X once, Y once
    nbytes = ell.vals.numel() * 8 + (A.shape[1] + A.shape[0]) * K * 4
    if okm:
        per = time_iterated(lambda v: ell_spmm(ell, v) * 1e-2, X, iters=16,
                            iters_small=2)
        _emit("spmm_ell_poisson512_k64", per,
              gflops=2 * A.nnz * K / per / 1e9,
              own_bytes_fraction=nbytes / per / hbm, correct=True)
    else:
        _error("spmm_ell_poisson512_k64")

    Au = matrices.load_or_synthesize("cant")
    bsr = BSR.from_scipy(Au, block=8, device=device)
    Xun = rng.standard_normal((bsr.shape[1], K)).astype(np.float32)
    Xu = torch.from_numpy(Xun).to(device)
    Aup = Au.copy()
    Aup.resize(bsr.shape)
    oku = np.allclose(_np(bsr_spmm(bsr, Xu)), Aup @ Xun, rtol=2e-3,
                      atol=2e-3)
    nbytes = bsr.blocks.numel() * 4 + bsr.indices.numel() * 4 \
        + (bsr.shape[1] + bsr.shape[0]) * K * 4
    if oku:
        per = time_iterated(lambda v: bsr_spmm(bsr, v) * 1e-2, Xu, iters=16,
                            iters_small=2)
        _emit("spmm_bsr_cant_k64", per, gflops=2 * Au.nnz * K / per / 1e9,
              own_bytes_fraction=nbytes / per / hbm, correct=True)
    else:
        _error("spmm_bsr_cant_k64")

    # CG: fixed 32 iterations (tol 0 never ends the loop) on SHIFTED
    # Poisson (A + I/2): the same structure and traffic, kappa ~17, so 32
    # iterations converge and the gate means something
    n_it = 32
    A_sh, D = shifted_dia(A, device)
    b = torch.ones((A.shape[0],), dtype=torch.float32, device=device)

    ran = []

    def cg_poisson(v):
        x, it = cg_fixed(lambda u: spmv.dia_spmv(D, u), v, n_it)
        ran.append(it)
        return v + x * 1e-30

    xs, _ = cg_fixed(lambda u: spmv.dia_spmv(D, u), b, n_it)
    r = _np(b) - A_sh @ _np(xs)
    okc = np.isfinite(r).all() and (
        np.linalg.norm(r) < 1e-3 * np.linalg.norm(_np(b)))
    if okc:
        per = time_iterated(cg_poisson, b, iters=4, iters_small=1)
        _emit_cg("cg_dia_poisson512s_32it", per, ran, A.nnz)
    else:
        _error("cg_dia_poisson512s_32it")

    # CG in pane layout on cant_like, which is NOT SPD: the fixed-iteration
    # workload loop; the gate checks the matvec itself against scipy
    sb = SBELL.from_scipy(Au, device=device)
    bu = x_to_panes(sb, torch.ones((sb.n_panes * 1024,), dtype=torch.float32,
                                   device=device))
    y_pane = panes_to_x(sb, sbell_spmv_panes(sb, bu))[:Au.shape[0]]
    oks = np.allclose(_np(y_pane), Au @ np.ones(Au.shape[1], np.float32),
                      rtol=2e-3, atol=2e-3)
    ran = []

    def cg_cant(v):
        x, it = pane_cg(sb, v, n_it)
        ran.append(it)
        return v + torch.nan_to_num(x, nan=0.0, posinf=0.0,
                                    neginf=0.0) * 1e-30

    if oks:
        per = time_iterated(cg_cant, bu, iters=4, iters_small=1)
        _emit_cg("cg_sbell_cant_32it", per, ran, Au.nnz, iters_run=True)
    else:
        _error("cg_sbell_cant_32it")


def bench_scale(n_block_rows: int = 260_000, window: int = 1 << 22,
                device="cuda"):
    """Single-card scale, oracle-gated before timing: a ~103M-nnz SBELL
    SpMV (one fused launch a matvec) and the exact windowed SpGEMM of
    pwtk_like (tests/test_gpu_benchmark/test_gpu_benchmark.cpp:12,96-126)."""
    from libhpc_tpu_torch.ops import spmv_sbell
    from libhpc_tpu_torch.ops.spgemm import spgemm_windowed
    from libhpc_tpu_torch.sparse.csr import CSR
    from libhpc_tpu_torch.sparse.sbell import SBELL

    hbm = harness.measure_hbm_bandwidth(device=device)
    hbm_r = harness.measure_hbm_read_bandwidth(device=device)

    t0 = time.perf_counter()
    # 260k block rows: ~103M nnz after the duplicates are summed
    A = matrices.block_random_fast(n_block_rows, blocks_per_row=8,
                                   half_band=6, far_fraction=0.01, seed=3)
    m, n = A.shape
    sb = SBELL.from_scipy(A, device=device)
    build_s = time.perf_counter() - t0

    xn = np.linspace(-1, 1, n).astype(np.float32)
    x = torch.from_numpy(xn).to(device)
    before = spmv_sbell.SPMV_LAUNCHES
    y = _np(spmv_sbell.sbell_spmv(sb, x))
    launches = spmv_sbell.SPMV_LAUNCHES - before
    if not np.allclose(y, A @ xn, rtol=2e-3, atol=2e-3):
        _error("spmv_sbell_100m_chunked")
    else:
        x3 = spmv_sbell.x_to_panes(
            sb, torch.nn.functional.pad(x, (0, sb.n_panes * 1024 - n)))
        # the matrix is the chain's operand, as in the reference
        per = harness.time_iterated(
            lambda v, sbv: spmv_sbell.sbell_spmv_panes(sbv, v),
            x3, iters=12, iters_small=2, operand=sb)
        rd, wr = harness.format_spmv_rw_bytes("sbell", sb, m, n)
        sol = harness.mixed_speed_of_light(hbm_r, hbm, rd, wr)
        _emit("spmv_sbell_100m_chunked", per,
              gnnz_per_s=A.nnz / per / 1e9,
              own_bytes_fraction=(rd + wr) / per / sol,
              nnz_m=round(A.nnz / 1e6, 1), launches=launches,
              build_s=round(build_s, 1), correct=True)
    del A, sb, x, y

    Ap = matrices.pwtk_like()
    Ac = CSR.from_scipy(Ap, device=device)
    lenB = np.diff(Ap.indptr).astype(np.int64)
    S = int(lenB[Ap.indices].sum())     # expansion size (partial products)
    _sync(device)
    t0 = time.perf_counter()
    C = spgemm_windowed(Ac, Ac, window=window)
    _sync(device)
    t_gemm = time.perf_counter() - t0
    Cref = (Ap @ Ap).tocsr()
    Cref.sort_indices()
    got = C.to_scipy().tocsr()
    got.sort_indices()
    if got.nnz == Cref.nnz and abs(got - Cref).max() < 1e-2:
        _emit("spgemm_windowed_pwtk_10m", t_gemm,
              g_products_per_s=S / t_gemm / 1e9,
              expansion_m=round(S / 1e6, 1),
              nnz_a_m=round(Ap.nnz / 1e6, 1),
              nnz_c_m=round(Cref.nnz / 1e6, 1), correct=True)
    else:
        _error("spgemm_windowed_pwtk_10m")


def bench_amg(device="cuda"):
    """AMG-preconditioned CG with SBELL smoothing: the solve's iterations
    and the V-cycle's time on the SPD-ified cant_like operator."""
    import scipy.sparse as sps

    from libhpc_tpu_torch.ops import multigrid_sbell as amg
    from libhpc_tpu_torch.ops.spmv_sbell import sbell_spmv

    B = matrices.load_or_synthesize("cant")
    A = (B + B.T).tocsr()
    rowsum = np.asarray(np.abs(A).sum(axis=1)).ravel()
    A = (A + sps.diags(rowsum + 1.0)).tocsr().astype(np.float32)
    H = amg.amg_setup(A, n_levels=3, coarse_max=3000, device=device)
    sb = H.levels[0].sbell
    rng = np.random.default_rng(5)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    bt = torch.from_numpy(b).to(device)
    x, it, _ = amg.amg_pcg(H, lambda v: sbell_spmv(sb, v), bt, tol=1e-6,
                           max_iter=200)
    r = b - A @ _np(x)
    if not np.linalg.norm(r) <= 2e-6 * max(np.linalg.norm(b), 1.0) * 10:
        _error("amg_pcg_cant_spd")
        return
    per = time_iterated(lambda v: amg.amg_vcycle(H, v) * 1e-6 + v * 0.5,
                        bt, iters=8, iters_small=2)
    _emit("amg_vcycle_cant_spd", per,
          levels=len(H.levels) + 1, pcg_iters=int(it), correct=True)


def bench_particle_writes(n: int = 1 << 20, grid_blocks: tuple = (256, 256),
                          block_size: int = 16, capacity: int = 65536,
                          device="cuda"):
    """Reference scale: 2^20 scattered writes (test_hpc_benchmark.cpp:866)
    over a 4096^2 domain."""
    from libhpc_tpu_torch.sparse.grid import BlockGrid

    rng = np.random.default_rng(0)
    extent = grid_blocks[0] * block_size
    xs = torch.from_numpy(rng.integers(0, extent, n).astype(np.int32)).to(
        device)
    ys = torch.from_numpy(rng.integers(0, extent, n).astype(np.int32)).to(
        device)
    vals = torch.ones((n,), dtype=torch.float32, device=device)
    g = BlockGrid.create(grid_blocks, block_size=block_size,
                         capacity=capacity, device=device)
    g = g.touch_batch(xs, ys)

    per = time_iterated(lambda g: g.write_batch(xs, ys, vals), g, iters=8,
                        iters_small=2)
    _emit("particle_writes_1M", per, gwrites_per_s=n / per / 1e9)
    per = time_iterated(lambda g: g.write_batch_dense(xs, ys, vals), g,
                        iters=8, iters_small=2)
    _emit("particle_writes_dense_1M", per, gwrites_per_s=n / per / 1e9)


def bench_layout(n: int = 1 << 25, device="cuda"):
    """AOS vs SOA vs AOSOA for a saxpy-like particle update
    (test_hpc_benchmark.cpp:35-144): interleaved (n, 3), three planar
    arrays, and (n/128, 3, 128) structs of 128-lane field vectors, at 32M
    particles (384 MB of live state, past the 50 MB L2)."""
    aos = torch.ones((n, 3), dtype=torch.float32, device=device)

    def step_aos(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        r = x * 1.1 + y * 0.9 + z
        return torch.stack([x + r * 1e-3, y * 1.0000001, z * 0.9999999],
                           dim=1)

    per = time_iterated(step_aos, aos, iters=256, iters_small=32)
    _emit("layout_aos_32M", per, gb_per_s=2 * aos.numel() * 4 / per / 1e9)

    soa = (torch.ones((n,), dtype=torch.float32, device=device),) * 3

    def step_soa(p):
        x, y, z = p
        r = x * 1.1 + y * 0.9 + z
        return (x + r * 1e-3, y * 1.0000001, z * 0.9999999)

    per = time_iterated(step_soa, soa, iters=256, iters_small=32)
    _emit("layout_soa_32M", per, gb_per_s=2 * 3 * n * 4 / per / 1e9)

    aosoa = torch.ones((n // 128, 3, 128), dtype=torch.float32, device=device)

    def step_aosoa(p):
        x, y, z = p[:, 0, :], p[:, 1, :], p[:, 2, :]
        r = x * 1.1 + y * 0.9 + z
        return torch.stack([x + r * 1e-3, y * 1.0000001, z * 0.9999999],
                           dim=1)

    per = time_iterated(step_aosoa, aosoa, iters=256, iters_small=32)
    _emit("layout_aosoa_32M", per,
          gb_per_s=2 * aosoa.numel() * 4 / per / 1e9)


def bench_access(n: int = 1 << 25, n_random: int = 1 << 22, device="cuda"):
    """Sequential vs random access (test_hpc_benchmark.cpp:146-290): a
    streaming pass over 128 MB, and a gather through a random permutation
    of 4M (gather-rate bound, so its size matters little)."""
    x = torch.ones((n,), dtype=torch.float32, device=device)
    per = time_iterated(lambda v: v * 1.0000001, x, iters=64, iters_small=8)
    _emit("access_sequential_128MB", per, gb_per_s=2 * n * 4 / per / 1e9)

    xr = torch.ones((n_random,), dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.permutation(n_random).astype(np.int32)).to(
        device)
    per = time_iterated(
        lambda v: v + torch.sum(v.index_select(0, idx)) * 1e-30, xr,
        iters=4, iters_small=1)
    _emit("access_random_16MB", per, gelem_per_s=n_random / per / 1e9)


def bench_dtypes(n: int = 1 << 27, device="cuda"):
    """The int-width and precision sweep (test_hpc_benchmark.cpp:928-1065):
    one stream at float32, bfloat16 and int8, 128M elements. The multiplier
    1.0078125 is exact in bfloat16 (1.0000001 rounds to 1.0 there)."""
    for dt, name in [(torch.float32, "f32"), (torch.bfloat16, "bf16"),
                     (torch.int8, "i8")]:
        x = torch.ones((n,), dtype=dt, device=device)
        if dt == torch.int8:
            step = lambda v: v ^ 1  # noqa: E731
        else:
            step = lambda v: v * 1.0078125  # noqa: E731
        per = time_iterated(step, x, iters=48, iters_small=6)
        _emit(f"dtype_stream_{name}_128M", per,
              gb_per_s=2 * x.numel() * x.element_size() / per / 1e9)


ALL = {
    "stream": bench_stream,
    "layout": bench_layout,
    "transpose": bench_transpose,
    "matmul": bench_matmul,
    "conv": bench_conv,
    "blur": bench_blur,
    "sort": bench_sort,
    "scan_hist": bench_scan_hist,
    "spmv": bench_spmv,
    "sbell": bench_sbell,
    "spmm_cg": bench_spmm_cg,
    "scale": bench_scale,
    "amg": bench_amg,
    "particles": bench_particle_writes,
    "access": bench_access,
    "dtypes": bench_dtypes,
}


def main(argv):
    """Run the named benches (all by default). A bench that raises prints
    {"bench": name, "error": ...} and the rest still run; then main
    raises RuntimeError naming every bench that raised."""
    failed = []
    for name in argv or list(ALL):
        try:
            ALL[name]()
        except Exception as e:  # noqa: BLE001 - reported, then re-raised
            traceback.print_exc()
            print(json.dumps({"bench": name, "error": str(e)}), flush=True)
            failed.append(name)
    if failed:
        raise RuntimeError(f"corpus benches failed: {failed}")


if __name__ == "__main__":
    main(sys.argv[1:])
