#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (libhpc_tpu_torch) on one NVIDIA GPU.

Drives the port's main path — scipy matrix -> SBELL container -> SBELL SpMV
through the hand-written CUDA kernels -> CG in pane layout — at the full
size of the two FEM matrices the repository models (cant_like: 62,000 rows,
3.1M nnz; pwtk_like: 218,000 rows, 12.0M nnz; both synthesized from fixed
seeds), and its CSR half (csr_spmv + CG on the shifted 1024x1024 Poisson).
Then the solver family on that path: aggregation AMG, whose every smoothing
sweep runs the SBELL SpMV kernel, geometric multigrid and the compensated
reductions, the distributed layer on a one-rank NCCL group (DistSBELL,
DistDIA, DistCSR, the 2-D SpMV, the halo stencils, distributed AMG-PCG and
the dry run; every shard of an 8-way DistSBELL partition held on the one
card), and the other sparse formats (COO, BSR, BELL, the banded
hybrid) with their SpMV and SpMM, SpGEMM (windowed and on 8 x 8 blocks at
pwtk_like size) and the utilities with the native host runtime.
Then the second entry point, sparse.auto_format, and the rest of the SpMV
family behind it: the streaming DIA kernel and its probe on Poisson 3072^2
(9.4M rows, 47.2M nnz), a CG solve through it, the plain DIA path, SELL on
Poisson 1024^2 and on a 2^20-row irregular band, and SELL-P. Then the sort
family, libHPC's flagship: merge_sort_u32 on 500,000,000 seeded u32 keys
(the reference bench's workload, bench.py:482-525, one 2^29 segment) and on
100,000,000 (three segments, so the pair merge runs), the radix pipeline
and bitonic network, and the histogram kernel on the keys' digit planes;
then its key-value form (merge_argsort_u32 on the 500M keys,
merge_sort_kv_u32 on 100M) and the exclusive scans on 500M elements. Then
the dense-array, stencil and grid layer at the corpus's sizes: row sums,
the transpose and the radius-8 box blur on 8192^2, the matmul at 1024^2
and 8192^2, the Poisson stencils, and 2^20 particle writes into the sparse
grids. Last, the micro-architecture suites: the harness's device-memory
probes, the memory/compute overlap sweep at its 512 MB and every probe of
bench/microarch.py, each kernel checked again past the 50 MB L2.

    python3 chip_smoke.py          # from the root of a checkout
    python3 chip_smoke.py --symgs  # the symgs phase alone, and its row

Phases, one JSON line each; a phase's line also gives the seconds since
the script started (t_s):
  0 device     card, versions, kernel build seconds, registers and
               spills of K18's FMA kernel, of the scan kernel, of the split
               search and merge-path kernels, of the chunk sorts' radix
               kernels (K8, K11), of K21b, of the SpMV kernel (K1-K3) and
               of K19, from the ptxas reports the build kept
  1 spmv       sbell_spmv on cant/pwtk in f32 and bf16 (one fused
               launch of csrc/sbell_spmv.cu a matvec): the fused SpMV, K1
               (near only) and K3 (far only) each against its plain
               PyTorch version on the card, the SpMV against scipy; times
               of each as CUDA events around 20 back-to-back calls, as
               graph replay, as device time from torch.profiler (whose
               split of the fused SpMV must hold one kernel and no memset)
               and with the L2 flushed (cold: CUPTI, and graph replay
               less the flushes)
  2 pane_chain two matvecs in pane layout equal A @ (A @ x)
  3 far        K3 alone against its plain version, with times
  4 cg         CG to tol 1e-5 on an SPD system built from cant_like, 32
               iterations at tol 0 on it, and 32 fixed iterations on
               cant_like (the cg_sbell_cant_32it workload)
  5 csr_cg     csr_spmv + 32 CG iterations on the shifted Poisson 1024^2
  6 dia        auto_format(poisson2d(3072)) is a DiaPallas; its matvec and
               the pattern probe; K4 and K5 against their plain versions,
               device times, GB/s and the fraction t_probe / t_kernel
  7 dia_cg     32 CG iterations through K4 on auto_format(Poisson 3072^2
               + I/2), with the true residual, three csrc/cg_vectors.cu
               launches an iteration (CG_VECTOR_LAUNCHES); then
    cg_vectors one iteration's three vector kernels on 2^24 float32
               entries against their plain versions and float64, device
               times of the kernels, the plain steps and the aten
               expressions the loop ran before them, beside 11 passes
               over 3.35 TB/s
    symgs      HPCG's multigrid at 256^3 (hpcbench/configs/hpcg_mg_256:
               four levels, 256^3 to 32^3, ops/multigrid_dia.py): a
               forward and a backward sweep of csrc/symgs_dia.cu on each
               level against sweep_torch on the card (1e-6 of max |x|),
               one V-cycle against the plain path on the host (1e-5) with
               SYMGS_LAUNCHES, MG_VCYCLES and DIA_LAUNCHES read around it
               (112, 1, 3); device times of a sweep on each level, of one
               256^3 colour, of the plain sweep and of a V-cycle, beside a
               sweep's least bytes over 3.35 TB/s
  8 dia_xla    auto_format(poisson2d(1024)) is a DIA (plain dia_spmv), and
               cg_dia_poisson1024s_32it
  9 sell       SELLSplit of Poisson 1024^2 (from ELL) and the SELL that
               auto_format picks for a 2^20-row irregular band: K6 against
               its plain version and scipy, with times
 10 sellp      SELL-P of Poisson 1024^2: K7 against its plain version and
               scipy, with times
 11 sort       merge_sort_u32 (K8 chunk sort, then each merge level a
               split search and a K9 merge) on 500M u32, exactly equal to
               torch.sort of the same keys; device time (one call replayed
               as a CUDA graph) and wall time beside torch.sort's and
               libHPC's 360 ms
 12 sort_segmented  the same on 100M u32 = [2^26, 2^24, 2^24] segments
               folded by two pair merges (K10)
 13 sort_kernels  K8, the staged 2^16 chunk sort, the split search, K9
               and K10 each exactly against its plain version on the
               buffers of a 2^26 sort, invert and unflip cases included,
               with device times (CUDA graph replays); K8 alone (one
               launch replayed as a graph; by CUPTI in sort_split); for
               K9/K10 the
               merge kernel alone and the split kernel alone (one launch
               replayed as a graph, and by CUPTI inside the whole call)
               beside the whole call; the merge kernel at windows of 2^11,
               2^12 and 2^13; chunk_sort_sweep: K8 and K11 alone at every
               sub-chunk size and digit width, and the staged chunk
               sorts at each sub-chunk size
 14 radix      radix_sort_pipeline, bitonic_sort, sort_u32 and argsort_u32
               (plain torch) on 2^22 keys against torch.sort
 15 histogram  K15 on the four 8-bit digit planes of the 500M keys, exactly
               against its plain version and the column sums of
               tile_histograms, with times
 16 argsort    merge_argsort_u32 (K11 chunk sort, K12 merge levels) on the
               500M keys of phase sort: keys exactly torch.sort's, order a
               permutation with keys[order] the sorted keys; device time
               (CUDA-graph replay) and wall time beside torch.sort's
 17 sort_kv_segmented  merge_sort_kv_u32 on 100M keys of a seeded 16-value
               alphabet (0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF among them)
               with float32 payloads: [2^26, 2^24, 2^24] segments, two K12
               pair merges; the (key, payload) pairs equal the input's
 18 kv_kernels K11, the staged 2^15 chunk, K12 as a level and as a pair,
               each exactly against its plain version (keys and payloads)
               on the buffers of a 2^26 sort of distinct keys; K11 alone
               (graph replay; CUPTI in sort_split), K12 alone and the
               split search alone beside the whole call, as in
               sort_kernels; K11's chunk_sort_sweep
 19 scan       K14 on 500M int32 flags (digit 0 of the keys == 0) exactly
               against its plain version and int64 cumsum, on a wraparound
               case; K13 on 500M seeded f32 within 1e-4 of a float64
               cumsum; both again at 2^22; times beside torch.cumsum
 20 reduce     K16 row_sum_pallas on (8192, 8192) f32 against its plain
               version (TOL_PLAIN) and a float64 row sum (rtol 1e-4);
               tree_reduce_sum (f32 and int32) and the segment ops on 2^24
               elements against float64 / int64 / sort-based oracles; times
               beside torch.sum
 21 transpose  transpose() on 8192^2 f32 (one K17 launch) exactly x.t();
               K17 on a ragged 5000 x 3001 int32 exactly; times beside
               x.t().contiguous()
 22 matmul     K18 at 1024^2 and 8192^2 on mean-zero operands, in f32
               (the FMA kernel, against its plain version and a float64
               product: at rtol 1e-4, atol 1e-3 at 1024^2, and within the
               float32 rounding bound sqrt(K) 2^-24 |A||B| at both sizes,
               which torch.matmul with TF32 on must miss) and in bf16 and
               f16 (the wgmma kernel after K17 on B, against the f32
               product of the rounded operands, 1e-2; K17's share, device
               times); times beside torch.matmul, TF32 off
 23 stencil    K19 blur2d_pallas on 8192^2, r = 8 (one launch, in the TMA
               load mode), against its plain version and a float64 box
               sum; blur_sweep: K19 at r = 1, 8, 32, 64 on 8192^2 and at
               r = 8 on 8191^2 (the plain-load mode), each against its
               plain version, with times and GB/s; the plain blur2d (cumsum
               form), F.avg_pool2d (zero-padded mean times 17^2, the
               library yardstick, within 1e-3 of K19) and one F.conv2d with
               a ones 17 x 17 weight (cuDNN, TF32 off) timed beside it;
               poisson5_apply on 2048^2 and
               poisson7_apply on 128^3 against csr_spmv of the Poisson
               matrices
 24 grid       the particle-write workload: 2^20 seeded unit writes over
               4096^2 into BlockGrid((256, 256), 16, 65536), touched in
               raster and morton order, write_batch, write_batch_dense and
               read_batch each equal to a dense index_put_ oracle, and a
               NestedGrid over the same domain; writes/s
 25 hbm        measure_hbm_bandwidth (in-place x *= c on 128 MB) and
               measure_hbm_read_bandwidth (sums of 512 MB) beside the data
               sheet's 3.35 TB/s
 26 overlap    overlap_chip.run at 512 MB: K20 over every w of WS, t(w),
               stream GB/s, t_unit, w* and overlap_efficiency; fails if
               t(64) <= t(0); K20 against its plain version at w = 0 and
               64, with times
 27 microarch  every bench of microarch.ALL at its defaults (records with
               the reference's keys, no error); K21a (S = 1024, 1024
               tiles), K21b (2^17 gathers of 4 KB rows, G = 256), K21c and
               K21d (2^20 rows) each exactly against its plain version,
               times beside torch.take_along_dim and index_select; K21b's
               ring (stages, rows a stage, rows in flight) and a sweep of
               its stages and stage rows, each exactly
 28 launches   the kernel launch counts of each path, which must cover
               every call it made (the CG path: exactly one fused SpMV
               launch a matvec, no near-only or far-only launch; each
               AMG solve's, (iterations + 1) x (a V-cycle's + a fine
               matvec's), 4 SBELL launches a level a V-cycle; the
               sort, kv sort, scan, histogram,
               dense-layer and micro-architecture paths: exactly the
               launches their sizes call for); each count is zeroed just
               before its path runs and read just after, and the launches
               made to compare a kernel with its plain version are not
               counted
 29 sort_split one 500M sort and one 500M argsort profiled (CUPTI) in a
               child process (chip_smoke.py --sort-split, a fresh
               profiler): device time and share of K8 / K11, of K9 / K12,
               of the split search kernel and of the torch ops left; K8
               and K11 alone on 2^26 keys
 29a amg       aggregation AMG (ops/multigrid_sbell.py) on the corpus's
               spd(cant_like) (corpus.py:465-495: n_levels 3, coarse_max
               3000; and smoothed aggregation) and on Poisson 512^2 (4
               levels): host setup time; one V-cycle makes exactly 4 SBELL
               launches a level (fused on a FarPane or empty far set, near
               on FarBlocks); AMG-PCG to tol 1e-6 on b ~ N(0, 1) from seed
               5, gated by the float64 residual (2e-5 max(|b|, 1) on cant,
               1e-4 on Poisson) in fewer iterations than plain CG, its
               launches zeroed just before the solve, read just after and
               held to (iterations + 1) x (a V-cycle's + a fine
               matvec's); the V-cycle by CUDA events (mean of 8), by graph
               replay and its host enqueue time, a PCG iteration on the
               host clock; the SpMV of every SBELL level of the hierarchy
               (the containers the V-cycle launches on) against its plain
               version, the fine one also against scipy
 29b dist      the distributed layer (libhpc_tpu_torch/parallel/) on a
               one-rank NCCL group over a file store: DistSBELL at one
               shard on cant_like and pwtk_like through dist_sbell_spmv_fn
               (exactly two SBELL kernel launches a matvec, gated against
               scipy and held to the single-card sbell_spmv; event times
               beside it and the all_gather alone), every shard of an
               8-way partition through shard_matvec with the global x (16
               launches, the joined y gated; each shard's diag and offd
               launch against near_out_panes_torch, with its graph-replay
               time and its tile stream's shape); DistDIA matvec and 32
               dist_dia_cg iterations on Poisson 3072^2 + I/2; dist_cg on
               Poisson 1024^2 + I/2; dist_blur2d_fn at 8192^2, r = 8,
               overlap off and on, against K19 (1e-3), and
               bench/overlap.run; dist_poisson_fn; dist2d_spmv_fn on a
               (1, 1) mesh; dist_amg_pcg on spd(cant_like) (launches held
               to 10 (iterations + 1), the amg phase's residual gate);
               dryrun_multichip(1); then the one-shard matvec's CUPTI
               split (its two SBELL launches, the NCCL all_gather, the
               torch ops left) in a child process (chip_smoke.py
               --dist-split, a fresh profiler)
 29c multigrid mg_solve on 4095^2 and mg_solve_cc on 4096^2 (f from seed
               0), 10 V-cycles each in float32, the residual recomputed in
               float64 on the card within 2x of the float32 floor (the
               float64 solution rounded to float32); a V-cycle's time
               (events and graph replay);
               r2 / r1 in float32 and float64; the reference tests'
               contraction r2 < 0.35 r1 / 0.4 r1 at 1023^2 / 1024^2
 29d precision sum_compensated on test_precision.py's adversarial set at
               2^26 elements and dot_compensated on 2^26 of its operands
               joined by pairs that cancel their rounded products, against
               float64 on the card, each error also at most plain's
               (torch.sum) or a quarter of it (torch.dot), with times
 29e formats   COO, BSR (8 x 8) and BELL SpMV and csr_spmv_t on cant_like,
               BandedHybrid on Poisson 1024^2 (natural order and RCM), and
               the corpus's SpMM cases spmm_ell_poisson512_k64 and
               spmm_bsr_cant_k64 (corpus.py:296-326), each against scipy
               at 2e-3, with times beside the torch.sparse CSR product
 29f spgemm    SpGEMM (no kernel of its own): pwtk_like A @ A windowed at
               2^22 slots a window (the reference's spgemm_pwtk_10m: 658.7M
               products, 158 windows in batches of 8; seconds, G
               products/s, the device time by CUDA events around each
               batch, the host's symbolic pass, prep, pulls and seam merge)
               and on 8 x 8 blocks with mxu on and off (spgemm_block_pwtk:
               wall time with the host symbolic pass, the numeric pass alone
               by graph replay, pairs, output blocks); spgemm, spgemm_csr
               and spgemm_blocked on cant_like (its ELL expansion printed
               first); each gated against scipy's product (max |C - A A| <
               1e-2 over both entry sets, the windowed form with scipy's
               nnz), timed beside torch.sparse.mm; no TF32 flag on
 29g runtime   the native host library (built by runtime/native.py in a
               thread beside the phases) and its self-test, an ArenaPool
               round trip, cant_like written to a .mtx and read by
               load_mtx_native (equal to scipy.io.mmread) into an SBELL
               and one fused SpMV against scipy, the host Morton encode
               against utils/morton on the card, a CG checkpoint resumed on
               the card (equal to resuming from the live state at rtol
               1e-6), the CSR checks on a good and a corrupted CUDA CSR,
               and a trace_to of a CG solve that names its annotate("cg")
               range
 29h corpus    the benchmark corpus (bench/corpus.py, libHPC's
               google-benchmark suite and this library's paths) at the
               reference's full sizes, all 40 records, in a child process
               (chip_smoke.py --corpus, corpus.main([]) one bench at a
               time, each bench's launch counters zeroed before it and read
               after it): fails on an error record, a missing, extra or
               reordered record, "correct" not true where the reference
               sets it, a kernel-reaching bench whose kernel (K1-K3 in the
               fused SBELL launch, with a FarPane where K3 is claimed;
               K8-K10 and the split search; K13; K15; K17; K19) did not
               launch, the 103M-nnz SpMV in other than one fused launch a
               matvec, or a TF32 flag on at a convolution; each SBELL
               record's real bytes (sbell_work) beside its time; then
               dryrun.entry()'s CG step on the card against the CPU's.
               The corpus's launches do not join the kernels line
 30 library    torch.sparse CSR matvecs of the SpMV kernels' matrices,
               the library yardstick of K1-K7 (after every profile)
 31 sass       the HGMMA (wgmma) lines in the library's SASS (fails at 0;
               cuobjdump runs beside the phases before)

Then a {"kernels": [...]} line (every kernel with its time, its plain
version's, its bound -- the larger of its bytes over 3.35 TB/s and its
operations over the card's peak for their type: 67 TFLOP/s in float32, 989
TFLOP/s for bfloat16 and float16 on the tensor cores -- and the time of one PyTorch
call computing the same function: a torch.sparse CSR matvec for the SpMV
kernels, torch.sort for the sorts, torch.bincount, torch.cumsum, torch.sum,
x.t().contiguous(), torch.matmul, F.avg_pool2d, torch.take_along_dim,
index_select), the `nvidia-smi` name and
power limit, and last {"ok": true, "device": {...}}.
Any failure raises: the script exits non-zero and prints no result. It
needs CUDA and the repository beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

TOL_PLAIN = 1e-5      # kernel vs plain version: rtol, and atol * max|y|
TOL_GATE = 2e-3       # vs scipy: the bench's correctness gate
TOL_SCAN = 1e-4       # K13 vs float64: rtol and atol (test_scan_reduce.py)
# scan sizes past a tile of 4096 and of 8192 (csrc/scan.cu's), and with many
# more tiles than resident blocks
EDGE_SIZES = (4097, 8193, (1 << 24) + 3)
TOL_ROW = 1e-4        # K16 vs float64: rtol (test_scan_reduce.py)
# the SymGS kernel vs sweep_torch, of max |x|: both sum a row's 26
# neighbours in float32, in other orders; a V-cycle compounds 14 sweeps and
# three K4 residuals (tests/test_torch_multigrid_dia.py)
TOL_SWEEP = 1e-6
TOL_VCYCLE = 1e-5
# K18 in float32 vs float64 at 1024^2: rtol 1e-4, atol 1e-3
# (test_histogram_transpose.py); at K = 8192 the rounding of a correct FP32
# sum of mean-zero terms nears that atol, so both sizes are held to the
# float32 rounding bound instead (fp32_bound_ratio)
TOL_MM = (1e-4, 1e-3)
# K18 in bfloat16 / float16 vs the float32 product of the rounded
# operands: its output is rounded once (relative 2^-9 / 2^-11), plus
# float32 order
TOL_MM_HALF = 1e-2

# the card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): device memory
# bytes a second, float32 operations a second outside the tensor cores, and
# dense bfloat16 (and float16) operations a second on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_BF16_OPS_S = 989e12

# (kind, case) -> (bytes the function must move, operations it does), the
# peak rate of those operations by kind (float32 unless listed), and
# kind -> ms of one PyTorch call computing the same function
WORK: dict = {}
OPS_PEAK = {"matmul_bf16": PEAK_BF16_OPS_S, "matmul_f16": PEAK_BF16_OPS_S}
LIBRARY_MS: dict = {}


START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's record also gets the seconds since the
    script started (`t_s`), so each phase's share of the run shows."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def warm_up_card(seconds: float = 1.0) -> None:
    """Keep the card busy for a while so its clocks leave idle before the
    first timed call."""
    import torch

    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = torch.tanh(a @ a * 1e-3)
        torch.cuda.synchronize()


def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Time per call from CUDA events around `reps` back-to-back calls
    (after `warmup` calls): the device time when the device is the
    bottleneck, the host's launch rate when the host is."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, want=None):
    """Device time per call: the summed durations of every GPU kernel and
    memset that `reps` calls of fn ran, from torch.profiler (CUPTI), with
    the per-kernel split. (None, {}) when three profiles in a row saw no
    device work or missed launches. `want` maps a substring of kernel
    names to the launches one call makes; a profile with fewer is lossy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        # a profile now and then comes back empty, or misses some of the
        # launches: every call launches the same kernels, so a count that
        # is not a multiple of reps marks a lossy profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name, count = {}, {}
        for e in prof.events():
            # the program's libhpc.* ranges are mirrored onto the device's
            # timeline as user annotations: they are not device work
            if (e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                us = e.time_range.elapsed_us()
                by_name[e.name] = by_name.get(e.name, 0.0) + us / reps / 1e3
                count[e.name] = count.get(e.name, 0) + 1
        seen = {w: sum(c for k, c in count.items() if w in k)
                for w in (want or {})}
        if (by_name and all(c % reps == 0 for c in count.values())
                and all(seen[w] == want[w] * reps for w in seen)):
            total = sum(by_name.values())
            return (total if total > 0 else None), by_name
    return None, {}


def graph_ms(fn, reps: int = 5) -> float:
    """Device time per call of fn without the host's gaps: one call
    captured in a CUDA graph (after a warm call on a side stream), `reps`
    replays timed with CUDA events; the kernels' durations plus the graph's
    short gaps between them. For functions of many small launches, where
    events around eager calls time the host, and where one profile would
    hold tens of thousands of records (the profiler then drops records in
    that profile and the ones after it). fn must not wait on the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, warmup=1, reps=reps)
    del graph
    return ms


def cold_device_ms(fn, reps: int = 10):
    """Device time per call with the L2 flushed before each call: a 256 MB
    device-to-device copy runs between calls, and its Memcpy events are
    left out of the sum (the timed functions make no such copy)."""
    import torch

    src = torch.empty(64 << 20, device="cuda")
    dst = torch.empty_like(src)

    def run():
        dst.copy_(src)
        fn()

    _, by_name = device_ms(run, reps)
    t = sum(v for k, v in by_name.items() if not k.startswith("Memcpy"))
    return t or None


def cold_graph_ms(fn, n: int = 10, reps: int = 10) -> float:
    """Device time per call of fn with the L2 flushed before each call, by
    graph replay: n (flush, call) pairs less n flushes, each captured back
    to back in one CUDA graph; a flush is a 64 MB device-to-device copy
    (128 MB through the 50 MB L2). For where a profile is lossy."""
    import torch

    src = torch.empty(16 << 20, device="cuda")
    dst = torch.empty_like(src)

    def flush():
        dst.copy_(src)

    def both():
        flush()
        fn()

    return graph_each_ms(both, n, reps) - graph_each_ms(flush, n, reps)


def wall_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of fn ending in a device synchronize (the
    solvers sync on the host every iteration, so events would not see it)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def leaf_bytes(container) -> int:
    """Bytes of a container's own tensor fields (nested ones left out)."""
    import dataclasses

    import torch

    return sum(nbytes(v) for f in dataclasses.fields(container)
               if isinstance(v := getattr(container, f.name), torch.Tensor))


def torch_csr(A, dev):
    """scipy matrix A as a float32 torch.sparse CSR tensor on dev."""
    import numpy as np
    import torch

    A = A.tocsr().astype(np.float32)
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data), size=A.shape).to(dev)


def csr_library_ms(A, dev) -> float:
    """One torch.sparse CSR matvec of scipy matrix A on the card (the
    library call computing the same product as K1-K7)."""
    import torch

    At = torch_csr(A, dev)
    x = torch.linspace(-1, 1, A.shape[1], device=dev)
    return time_ms(lambda: At @ x)


def max_err(got, want) -> float:
    return float((got - want).abs().max())


def assert_close(got, want, what: str, rtol: float, atol_rel: float):
    import torch

    scale = float(want.abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol_rel * scale):
        raise AssertionError(
            f"{what}: max |diff| {max_err(got, want)} at max|ref| {scale}")


def gate(y, ref, what: str) -> None:
    import numpy as np

    y = y.cpu().numpy()
    if not np.allclose(y, ref, rtol=TOL_GATE, atol=TOL_GATE):
        raise AssertionError(f"{what}: fails the {TOL_GATE} gate vs scipy, "
                             f"max |diff| {np.abs(y - ref).max()}")


def quantized(A):
    import torch

    Aq = A.copy()
    Aq.data = torch.from_numpy(A.data).to(torch.bfloat16).float().numpy()
    return Aq


def graph_each_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time per call of fn: n calls captured back to back in one
    CUDA graph, replayed `reps` times (graph_ms over n). For launches of a
    few microseconds, where events around eager calls time the host, and
    where a profile would add to the profiles of one process."""
    def many():
        for _ in range(n):
            fn()

    return graph_ms(many, reps) / n


def sbell_work(sbd, x3, out, near: bool, far: bool):
    """(bytes, operations) an SBELL SpMV mode must move and do on these
    inputs: the real tiles' values, meta and pane, tile_ptr; the far set's
    real entries (64 values, pane, lane and output lane each); x3 and the
    output once; two operations a stored value."""
    nb = nbytes(x3, out)
    ops = 0
    if near:
        n_real = int(sbd.tile_ptr[-1])
        nb += (n_real * (sbd.vflat.element_size() * 64 * 128 + 128 * 4 + 4)
               + nbytes(sbd.tile_ptr))
        ops += 2 * n_real * 64 * 128
    if far:
        fp = sbd.far
        nb += fp.n_far * (64 * fp.bt.element_size() + 3 * 4)
        ops += 2 * fp.n_far * 64
    return nb, ops


def spmv_phase(name, A, sb, dev, kernel_times):
    """Phase 1 and 3 for one container (f32 or bf16) of matrix `name`."""
    import numpy as np
    import torch

    from libhpc_tpu_torch.ops import far_sbell, spmv_sbell
    from libhpc_tpu_torch.sparse.sbell import B, W_PANES, FarPane

    dtype = str(sb.vflat.dtype).replace("torch.", "")
    sbd = sb.to(dev)
    if not isinstance(sbd.far, FarPane):
        raise AssertionError(f"{name}: far set is {type(sbd.far).__name__}, "
                             "expected FarPane")
    m, n = A.shape
    x = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    xd = torch.from_numpy(x).to(dev)
    xpad = torch.nn.functional.pad(xd, (0, sbd.n_panes * 1024 - n))
    x3 = spmv_sbell.x_to_panes(sbd, xpad)
    guarded = (sbd.n_stripes + W_PANES - 1) * B

    def plain_panes(v3):
        return (spmv_sbell.near_out_panes_torch(sbd, v3)
                + far_sbell.far_pane_out_panes_torch(sbd.far, v3, guarded)
                ).reshape(-1, B, 128)

    y = spmv_sbell.sbell_spmv(sbd, xd)
    y_plain = spmv_sbell.panes_to_x(sbd, plain_panes(x3))[:m]
    assert_close(y, y_plain, f"{name} {dtype} sbell_spmv vs plain",
                 TOL_PLAIN, TOL_PLAIN)
    oracle = (quantized(A) if dtype == "bfloat16" else A) @ x
    gate(y, oracle, f"{name} {dtype} sbell_spmv")

    spmv_k = spmv_sbell.sbell_spmv_panes(sbd, x3)
    spmv_p = plain_panes(x3)
    assert_close(spmv_k, spmv_p, f"{name} {dtype} fused SpMV kernel",
                 TOL_PLAIN, TOL_PLAIN)
    near_k = spmv_sbell.near_out_panes(sbd, x3)
    near_p = spmv_sbell.near_out_panes_torch(sbd, x3)
    assert_close(near_k, near_p, f"{name} {dtype} near kernel", TOL_PLAIN,
                 TOL_PLAIN)
    far_k = far_sbell.far_pane_out_panes(sbd.far, x3, guarded)
    far_p = far_sbell.far_pane_out_panes_torch(sbd.far, x3, guarded)
    assert_close(far_k, far_p, f"{name} {dtype} far kernel", TOL_PLAIN,
                 TOL_PLAIN)

    kernels = {
        "near": lambda: spmv_sbell.near_out_panes(sbd, x3),
        "far": lambda: far_sbell.far_pane_out_panes(sbd.far, x3, guarded),
        "spmv": lambda: spmv_sbell.sbell_spmv_panes(sbd, x3),
    }
    plains = {
        "near_plain": lambda: spmv_sbell.near_out_panes_torch(sbd, x3),
        "far_plain": lambda: far_sbell.far_pane_out_panes_torch(
            sbd.far, x3, guarded),
        "spmv_plain": lambda: plain_panes(x3),
    }
    fns = {**kernels, **plains}
    ev = {k: time_ms(f) for k, f in fns.items()}
    gr = {k: graph_each_ms(f) for k, f in fns.items()}
    # device time: CUPTI for the kernels (graph replay where a profile was
    # lossy), graph replay for the plain versions; cold: the L2 flushed,
    # by CUPTI and by graph replay
    dv, split, cold, cold_gr = {}, {}, {}, {}
    for k, f in kernels.items():
        dv[k], split[k] = device_ms(f)
        cold[k] = cold_device_ms(f)
        cold_gr[k] = cold_graph_ms(f)
    t = {k: dv.get(k) or gr[k] for k in fns}
    if split["spmv"] and (len(split["spmv"]) != 1 or not all(
            "sbell_spmv_kernel" in k for k in split["spmv"])):
        raise AssertionError(f"{name} {dtype}: the fused SpMV ran "
                             f"{sorted(split['spmv'])}, expected one "
                             "sbell_spmv_kernel and nothing else")
    case = f"{name}/{dtype}"
    for k, got, want in (("near", near_k, near_p), ("far", far_k, far_p),
                         ("spmv", spmv_k, spmv_p)):
        kernel_times[k][case] = (t[k], t[f"{k}_plain"], max_err(got, want))
        WORK[(k, case)] = sbell_work(sbd, x3, got, k != "far", k != "near")
    t_spmv = t["spmv"]
    emit({"phase": "spmv", "matrix": name, "dtype": dtype, "rows": m,
          "nnz": int(A.nnz), "n_stripes": sbd.n_stripes,
          "n_tiles": sbd.n_tiles, "hbm_bytes": sbd.hbm_bytes,
          "k_max": sbd.k_max,
          "max_abs_err_vs_plain": max_err(y, y_plain),
          "fused_max_abs_err_vs_plain": max_err(spmv_k, spmv_p),
          "max_abs_err_vs_scipy": float(np.abs(y.cpu().numpy()
                                               - oracle).max()),
          **{f"{k}_event_ms": ev[k] for k in ("near", "near_plain", "spmv",
                                              "spmv_plain")},
          **{f"{k}_device_ms": dv[k] for k in ("near", "spmv")},
          **{f"{k}_graph_ms": gr[k] for k in ("near", "near_plain", "spmv",
                                              "spmv_plain")},
          **{f"{k}_cold_device_ms": cold[k] for k in ("near", "spmv")},
          **{f"{k}_cold_graph_ms": cold_gr[k] for k in ("near", "spmv")},
          **{f"{k}_bound_ms": max(WORK[(k, case)][0] / PEAK_BYTES_S,
                                  WORK[(k, case)][1] / PEAK_F32_OPS_S) * 1e3
             for k in ("near", "spmv")},
          "spmv_device_split_ms": split["spmv"],
          "gnnz_per_s": A.nnz / (t_spmv * 1e-3) / 1e9,
          "hbm_gb_per_s": sbd.hbm_bytes / (t_spmv * 1e-3) / 1e9})
    emit({"phase": "far", "matrix": name, "dtype": dtype,
          "n_grouped": sbd.far.n_grouped, "e_pad": sbd.far.e_pad,
          "d_max": sbd.far.d_max, "n_far": sbd.far.n_far,
          "max_abs_err_vs_plain": max_err(far_k, far_p),
          **{f"{k}_event_ms": ev[k] for k in ("far", "far_plain")},
          "far_device_ms": dv["far"], "far_cold_device_ms": cold["far"],
          "far_cold_graph_ms": cold_gr["far"],
          **{f"{k}_graph_ms": gr[k] for k in ("far", "far_plain")},
          "far_bound_ms": max(WORK[("far", case)][0] / PEAK_BYTES_S,
                              WORK[("far", case)][1] / PEAK_F32_OPS_S) * 1e3})
    return sbd


def pane_chain_phase(name, A, sbd, dev):
    import numpy as np
    import torch

    from libhpc_tpu_torch.ops import spmv_sbell

    m, n = A.shape
    xpad = np.zeros(sbd.n_panes * 1024, np.float32)
    xpad[:n] = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    x3 = spmv_sbell.x_to_panes(sbd, torch.from_numpy(xpad).to(dev))
    o3 = spmv_sbell.sbell_spmv_panes(sbd, x3)
    if not bool(torch.all(o3[sbd.n_stripes:] == 0)):
        raise AssertionError(f"{name}: guard stripes not zero")
    y2 = spmv_sbell.panes_to_x(sbd, spmv_sbell.sbell_spmv_panes(sbd, o3))
    want = A @ (A @ xpad[:n].astype(np.float64))
    got = y2[:m].cpu().numpy().astype(np.float64)
    scale = np.abs(want).max()
    err = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=1e-3, atol=1e-4 * scale):
        raise AssertionError(f"{name}: pane chain max |diff| {err}")
    emit({"phase": "pane_chain", "matrix": name, "max_abs_err": err,
          "max_abs_ref": float(scale)})


def spd_from(A):
    """SPD system from A: symmetrize, then add diag(|A| rowsum + 1)."""
    import numpy as np
    import scipy.sparse as sps

    As = A + A.T
    rowsum = np.asarray(np.abs(As).sum(axis=1)).ravel()
    return (As + sps.diags(rowsum + 1.0)).tocsr().astype(np.float32)


def cg_phase(A_cant, sb_cant, dev):
    """Phase 4: the main path. Returns the number of matvecs it made."""
    import numpy as np
    import torch

    from libhpc_tpu_torch.ops import solver, spmv_sbell
    from libhpc_tpu_torch.sparse.sbell import SBELL

    A = spd_from(A_cant)
    n = A.shape[0]
    t0 = time.perf_counter()
    sb = SBELL.from_scipy(A, device=dev)
    build_s = time.perf_counter() - t0
    b = np.zeros(sb.n_panes * 1024, np.float32)
    b[:n] = 1.0
    b3 = spmv_sbell.x_to_panes(sb, torch.from_numpy(b).to(dev))

    calls = [0]

    def matvec(s, u):
        calls[0] += 1
        return spmv_sbell.sbell_spmv_panes(s, u)

    out = {}

    def solve():
        out["r"] = solver.cg(lambda u: matvec(sb, u), b3, tol=1e-5)

    ms = wall_ms(solve)
    x3, it, res2 = out["r"]
    x = spmv_sbell.panes_to_x(sb, x3)[:n].cpu().numpy().astype(np.float64)
    r = np.linalg.norm(b[:n] - A @ x)
    if not (np.all(np.isfinite(x)) and 0 < it < 1000
            and r <= 1e-4 * np.linalg.norm(b[:n])):
        raise AssertionError(f"SPD CG: {it} iterations, true residual {r}")
    emit({"phase": "cg", "system": "spd(cant_like)", "rows": n,
          "nnz": int(A.nnz), "far": type(sb.far).__name__,
          "sbell_build_s": build_s, "iterations": it, "ms": ms,
          "res2": float(res2),
          "ms_per_iteration": ms / it,
          "true_residual_rel": float(r / np.linalg.norm(b[:n]))})

    # the solver loop's throughput: 32 iterations at tol=0 on the SPD system
    n_it = 32

    def spd32():
        out["r"] = solver.cg(lambda u: matvec(sb, u), b3, tol=0.0,
                             max_iter=n_it)

    ms32 = wall_ms(spd32)
    xs, it32, _ = out["r"]
    if it32 != n_it or not bool(torch.isfinite(xs).all()):
        raise AssertionError(f"spd(cant_like) 32 iterations: ran {it32}")
    emit({"phase": "cg", "system": "spd(cant_like) 32 iterations",
          "iterations": it32, "ms": ms32,
          "iters_per_s": it32 / (ms32 * 1e-3),
          "gnnz_per_s": it32 * A.nnz / (ms32 * 1e-3) / 1e9})

    # cg_sbell_cant_32it: 32 fixed iterations on cant_like; its gate is one
    # pane matvec against scipy. cant_like is not SPD, so CG may break down
    # (p.Ap -> 0 gives a non-finite rs, which ends the loop) before 32
    # iterations: the record keeps the iterations actually run.
    mu, nu = A_cant.shape
    bu = spmv_sbell.x_to_panes(
        sb_cant, torch.ones(sb_cant.n_panes * 1024, device=dev))
    y1 = spmv_sbell.panes_to_x(sb_cant, matvec(sb_cant, bu))[:mu]
    gate(y1, A_cant @ np.ones(nu, np.float32), "cg_sbell_cant_32it matvec")

    def run32():
        out["r"] = solver.cg(lambda u: matvec(sb_cant, u), bu, tol=0.0,
                             max_iter=n_it)

    ms32 = wall_ms(run32)
    xs, it32, res32 = out["r"]
    if it32 < 1:
        raise AssertionError("cg_sbell_cant_32it ran no iteration")
    emit({"phase": "cg", "system": "cg_sbell_cant_32it", "iterations": it32,
          "finite": bool(torch.isfinite(xs).all()), "res2": float(res32),
          "ms": ms32, "iters_per_s": it32 / (ms32 * 1e-3),
          "gnnz_per_s": it32 * A_cant.nnz / (ms32 * 1e-3) / 1e9})
    return calls[0]


def csr_cg_phase(dev):
    import numpy as np
    import scipy.sparse as sps
    import torch

    from libhpc_tpu_torch.bench import matrices
    from libhpc_tpu_torch.ops import solver
    from libhpc_tpu_torch.sparse.csr import CSR

    A_s = matrices.poisson2d(1024)
    A = (A_s + sps.eye(A_s.shape[0]) * 0.5).tocsr().astype(np.float32)
    csr = CSR.from_scipy(A, device=dev)
    b = torch.ones(A.shape[0], device=dev)
    n_it = 32
    out = {}

    def run():
        out["r"] = solver.cg(lambda u: csr @ u, b, tol=0.0, max_iter=n_it)

    ms = wall_ms(run)
    x, it, _ = out["r"]
    r = np.ones(A.shape[0]) - A @ x.cpu().numpy().astype(np.float64)
    if not (np.isfinite(r).all()
            and np.linalg.norm(r) < 1e-3 * np.sqrt(A.shape[0])):
        raise AssertionError(f"CSR CG residual {np.linalg.norm(r)}")
    emit({"phase": "csr_cg", "system": "poisson2d(1024)+I/2", "rows":
          A.shape[0], "nnz": int(A.nnz), "iterations": it, "ms": ms,
          "residual": float(np.linalg.norm(r))})


AMG_SEED = 5             # b ~ N(0, 1) of the corpus workload (corpus.py:485)
# ||b - Ax|| <= gate * max(||b||, 1), in float64: the corpus's gate for
# spd(cant_like) (corpus.py:465-495); the Poisson 512^2 system (condition
# ~1e5) holds the float32 solution to 1e-4, its residual from tol 1e-6
# being ~1.3e-5 on the CPU
AMG_GATE = 2e-5
AMG_GATE_POISSON = 1e-4
# sum_compensated's bound of tests/test_precision.py, 1e-2 at its sum of
# |x| (~5.0e11), relative to that sum: the double-float tree's error grows
# with n (the reference's equals the port's bit for bit)
SUM_BOUND_REL = 1e-2 / 5.0e11


def level_nnz(sb) -> int:
    """Nonzeros a level's SBELL stores (its near tiles and its far set)."""
    import torch

    from libhpc_tpu_torch.sparse.sbell import FarBlocks, FarPane

    vals = [sb.vflat]
    if isinstance(sb.far, FarBlocks):
        vals.append(sb.far.blocks)
    elif isinstance(sb.far, FarPane):
        vals.append(sb.far.bt)
    return sum(int(torch.count_nonzero(v)) for v in vals)


def hold_level_spmv(name, li, lev, A=None):
    """The fused SpMV of one level of the hierarchy, on the container the
    V-cycle launches on, against its plain version (near_out_panes_torch
    plus the plain far set) on the card; the fine level also against
    scipy. These launches compare; they are not the main path's."""
    import numpy as np
    import torch

    from libhpc_tpu_torch.ops import far_sbell, spmv, spmv_sbell
    from libhpc_tpu_torch.sparse.sbell import B, W_PANES, FarPane

    sb = lev.sbell
    x = np.random.default_rng(li).standard_normal(
        sb.n_panes * 1024).astype(np.float32)
    x[lev.n:] = 0.0
    x3 = spmv_sbell.x_to_panes(sb, torch.from_numpy(x).to(sb.device))
    got = spmv_sbell.sbell_spmv_panes(sb, x3).reshape(-1, 128)
    want = spmv_sbell.near_out_panes_torch(sb, x3)
    if isinstance(sb.far, FarPane):
        want = want + far_sbell.far_pane_out_panes_torch(
            sb.far, x3, (sb.n_stripes + W_PANES - 1) * B)
    elif sb.far is not None:
        yfar = spmv.far_spmv(sb.far, x3[:sb.n_panes].transpose(1, 2)
                             .reshape(-1))
        want[:sb.n_stripes * B] += yfar.reshape(sb.n_stripes, 128, B) \
            .transpose(1, 2).reshape(-1, 128)
    assert_close(got, want, f"{name} level {li} SpMV vs plain", TOL_PLAIN,
                 TOL_PLAIN)
    if A is not None:
        y = spmv_sbell.panes_to_x(sb, got.reshape(-1, B, 128))[:lev.n]
        gate(y, A @ x[:lev.n], f"{name} level {li} SpMV")
    return {"level": li, "rows": lev.n, "nnz": level_nnz(sb),
            "n_stripes": sb.n_stripes, "n_tiles": sb.n_tiles,
            "k_max": sb.k_max, "far": type(sb.far).__name__,
            "max_abs_err_vs_plain": max_err(got, want)}


def amg_system(name, A, dev, setup_kw, cg_max_iter, gate_rel):
    """One AMG-PCG system: setup (host), the launches of one V-cycle, the
    solve to tol 1e-6 with its launches counted and checked, plain CG, the
    V-cycle's time, each level's SpMV against its plain version. Returns
    its record and the launches of its solve: (fused, fused on a FarPane
    level, near)."""
    import numpy as np
    import torch

    from libhpc_tpu_torch.ops import multigrid_sbell as amg
    from libhpc_tpu_torch.ops import solver, spmv_sbell
    from libhpc_tpu_torch.sparse.sbell import FarBlocks, FarPane

    t0 = time.perf_counter()
    H = amg.amg_setup(A, device=dev, **setup_kw)
    setup_s = time.perf_counter() - t0
    n = A.shape[0]
    b = np.random.default_rng(AMG_SEED).standard_normal(n) \
        .astype(np.float32)
    bd = torch.from_numpy(b).to(dev)
    sb = H.levels[0].sbell

    def matvec(v):
        return spmv_sbell.sbell_spmv(sb, v)

    def product(s):
        """(fused, fused with a FarPane, near) launches of one product:
        a FarBlocks far set takes a near launch and the plain far_spmv."""
        if isinstance(s.far, FarBlocks):
            return np.array([0, 0, 1])
        return np.array([1, int(isinstance(s.far, FarPane)), 0])

    per_level = H.pre - 1 + 1 + H.post
    vcycle = per_level * sum(product(lev.sbell) for lev in H.levels)
    spmv_sbell.SPMV_LAUNCHES = spmv_sbell.NEAR_LAUNCHES = 0
    amg.amg_vcycle(H, bd)
    torch.cuda.synchronize()
    got = (spmv_sbell.SPMV_LAUNCHES, spmv_sbell.NEAR_LAUNCHES)
    if got != (vcycle[0], vcycle[2]):
        raise AssertionError(f"{name}: one V-cycle launched (fused, near) "
                             f"{got}, expected {vcycle[[0, 2]]}")
    # the main path's run: pcg_op makes it + 1 fine matvecs and it + 1
    # V-cycles; the counts are read right after it, and nothing else adds
    # to them
    torch.cuda.synchronize()
    spmv_sbell.SPMV_LAUNCHES = spmv_sbell.NEAR_LAUNCHES = 0
    t0 = time.perf_counter()
    x, it, _ = amg.amg_pcg(H, matvec, bd, tol=1e-6, max_iter=200)
    torch.cuda.synchronize()
    pcg_ms = (time.perf_counter() - t0) * 1e3
    got = (spmv_sbell.SPMV_LAUNCHES, spmv_sbell.NEAR_LAUNCHES)
    solve = (it + 1) * (vcycle + product(sb))
    if got != (solve[0], solve[2]):
        raise AssertionError(f"{name}: AMG-PCG made {it} iterations and "
                             f"launched (fused, near) {got}, expected "
                             f"{solve[[0, 2]]}")
    r = np.linalg.norm(b.astype(np.float64)
                       - A @ x.cpu().numpy().astype(np.float64))
    limit = gate_rel * max(np.linalg.norm(b), 1.0)
    if not (np.isfinite(r) and r <= limit and 0 < it < 200):
        raise AssertionError(f"{name} AMG-PCG: {it} iterations, true "
                             f"residual {r} > {limit}")
    _, it_cg, _ = solver.cg(matvec, bd, tol=1e-6, max_iter=cg_max_iter)
    if not it < it_cg:
        raise AssertionError(f"{name}: AMG-PCG took {it} iterations, "
                             f"plain CG {it_cg}")
    vcycle_ms = time_ms(lambda: amg.amg_vcycle(H, bd), warmup=2, reps=8)
    # the same V-cycle without the host: replayed from a CUDA graph, and
    # the host's time to enqueue one (no sync inside)
    vcycle_graph_ms = graph_ms(lambda: amg.amg_vcycle(H, bd), reps=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amg.amg_vcycle(H, bd)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    # CUPTI: the V-cycle's device time and the SBELL kernel's share (None
    # where the profile, late in the process, lost records)
    cupti_ms, split = device_ms(lambda: amg.amg_vcycle(H, bd), reps=8,
                                want={"sbell_spmv_kernel":
                                      int(vcycle[0] + vcycle[2])})
    kernel_ms = sum(v for k, v in split.items() if "sbell_spmv_kernel" in k)
    matvec_ms = time_ms(lambda: matvec(bd))
    levels = [hold_level_spmv(name, li, lev, A if li == 0 else None)
              for li, lev in enumerate(H.levels)]
    rec = {"phase": "amg", "system": name, "rows": n, "nnz": int(A.nnz),
           "setup_kw": setup_kw, "setup_s": setup_s,
           "sbell_levels": levels,
           "coarse_rows": H.coarse_inv.shape[0],
           "vcycle_launches_fused": int(vcycle[0]),
           "vcycle_launches_near": int(vcycle[2]),
           "pcg_launches_fused": int(solve[0]),
           "pcg_launches_near": int(solve[2]),
           "pcg_iterations": it, "cg_iterations": it_cg,
           "true_residual": float(r), "gate": float(limit),
           "pcg_ms": pcg_ms, "pcg_ms_per_iteration": pcg_ms / it,
           "vcycle_ms": vcycle_ms, "vcycle_graph_ms": vcycle_graph_ms,
           "vcycle_enqueue_ms": enqueue_ms, "vcycle_cupti_ms": cupti_ms,
           "vcycle_cupti_sbell_kernel_ms": kernel_ms if cupti_ms else None,
           "fine_matvec_ms": matvec_ms}
    return rec, solve


def amg_phase(dev) -> list:
    """Phase 29a: aggregation AMG on the SBELL kernel. Returns the
    launches of its three solves, counted and checked: (fused, fused with
    a FarPane, near)."""
    import numpy as np

    from libhpc_tpu_torch.bench import matrices

    A = spd_from(matrices.load_or_synthesize("cant"))
    total = np.zeros(3, np.int64)
    for name, A_s, kw, cg_max, gate_rel in (
            ("spd(cant_like)", A, dict(n_levels=3, coarse_max=3000), 1000,
             AMG_GATE),
            ("spd(cant_like) smoothed", A,
             dict(n_levels=3, coarse_max=3000, smooth_p=True), 1000,
             AMG_GATE),
            ("poisson512", matrices.poisson2d(512),
             dict(n_levels=4, coarse_max=3000), 5000, AMG_GATE_POISSON)):
        rec, solve = amg_system(name, A_s, dev, kw, cg_max, gate_rel)
        total += solve
        AMG_RECORDS[name] = rec
        emit(rec)
    return [int(v) for v in total]


DIST_SHARDS = 8          # the partition held shard by shard on the one card
DIST_GROUP_TIMEOUT_S = 120
# the amg phase's records by system, read by the dist phase
AMG_RECORDS: dict = {}


def dist_sbell_case(name, A, mesh, dev) -> tuple:
    """DistSBELL of matrix `name` at one shard through dist_sbell_spmv_fn
    (the main path: two SBELL kernel launches a matvec, counted), gated
    against scipy and held to the single-card sbell_spmv, timed beside it
    and beside the all_gather alone; then every shard of a DIST_SHARDS-way
    partition through shard_matvec with the global x as xg (launches
    counted, the joined y gated against scipy), each shard's diag and offd
    launch held against near_out_panes_torch on its own SBELL (these
    compare; they are not counted). Returns (record, counted launches)."""
    import numpy as np
    import torch

    from libhpc_tpu_torch.ops import far_sbell, spmv_sbell
    from libhpc_tpu_torch.parallel.collectives import all_gather
    from libhpc_tpu_torch.parallel.dist_sbell import (DistSBELL,
                                                      dist_sbell_spmv_fn,
                                                      shard_matvec)
    from libhpc_tpu_torch.sparse.sbell import SBELL

    def zero():
        torch.cuda.synchronize()
        spmv_sbell.SPMV_LAUNCHES = spmv_sbell.NEAR_LAUNCHES = 0
        far_sbell.FAR_LAUNCHES = 0

    def counts():
        torch.cuda.synchronize()
        return (spmv_sbell.SPMV_LAUNCHES, spmv_sbell.NEAR_LAUNCHES,
                far_sbell.FAR_LAUNCHES)

    m, n = A.shape
    x = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    oracle = A @ x
    t0 = time.perf_counter()
    host1 = DistSBELL.from_scipy(A, 1)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    d1 = host1.shard(mesh)
    torch.cuda.synchronize()
    shard_mem = torch.cuda.memory_allocated() - mem0
    build1_s = time.perf_counter() - t0
    b1 = d1.blocks
    block_tensors = [v for c in (b1.diag, b1.offd, b1.far) if c is not None
                     for v in vars(c).values() if isinstance(v, torch.Tensor)]
    block_bytes = nbytes(*block_tensors)
    # the card holds the shard once: its ShardSBELL, the stacked leaves on
    # the host. The caching allocator may hand a tensor a cached block up to
    # 1 MiB larger than asked (512 B under 1 MiB), and counts the block.
    slack = sum(1 << 20 if nbytes(t) >= 1 << 20 else 512
                for t in block_tensors)
    if shard_mem > block_bytes + slack or d1.diag_vflat.is_cuda:
        raise AssertionError(f"{name}: .shard() took {shard_mem} B of "
                             f"device memory for {block_bytes} B of blocks "
                             f"(allocator slack {slack} B)")
    matvec = dist_sbell_spmv_fn(d1, mesh)
    xd = torch.nn.functional.pad(torch.from_numpy(x).to(dev),
                                 (0, d1.shape[1] - n))
    zero()
    y = matvec(xd)
    launched = counts()
    if launched != (2, 0, 0):
        raise AssertionError(f"{name}: a DistSBELL matvec launched (fused, "
                             f"near, far) {launched}, expected (2, 0, 0)")
    gate(y[:m], oracle, f"{name} dist_sbell_spmv")
    sb = SBELL.from_scipy(A, device=dev)
    xs = torch.from_numpy(x).to(dev)
    y1 = spmv_sbell.sbell_spmv(sb, xs)
    assert_close(y[:m], y1, f"{name} dist_sbell_spmv vs sbell_spmv",
                 TOL_PLAIN, TOL_PLAIN)
    t_dist = time_ms(lambda: matvec(xd))
    t_single = time_ms(lambda: spmv_sbell.sbell_spmv(sb, xs))
    t_gather = time_ms(lambda: all_gather(xd, "x", mesh=mesh))
    total = 2

    t0 = time.perf_counter()
    d8 = DistSBELL.from_scipy(A, DIST_SHARDS)
    build8_s = time.perf_counter() - t0
    rl = d8.rows_local
    xg = torch.nn.functional.pad(xs, (0, d8.shape[1] - n))
    blocks = [d8.shard_blocks(s, dev) for s in range(DIST_SHARDS)]
    zero()
    ys = [shard_matvec(b, xg[s * rl:(s + 1) * rl], xg)
          for s, b in enumerate(blocks)]
    launched = counts()
    if launched != (2 * DIST_SHARDS, 0, 0):
        raise AssertionError(f"{name}: {DIST_SHARDS} shards launched "
                             f"{launched}, expected ({2 * DIST_SHARDS}, 0, 0)")
    total += 2 * DIST_SHARDS
    y8 = torch.cat(ys)
    gate(y8[:m], oracle, f"{name} {DIST_SHARDS} shards' shard_matvec")
    shards = []
    for s, b in enumerate(blocks):
        rec = {"shard": s, "far_blocks": int(b.far.n_far) if b.far is not None
               else 0}
        for part, sbs, v in (("diag", b.diag, xg[s * rl:(s + 1) * rl]),
                             ("offd", b.offd, xg)):
            x3 = spmv_sbell.x_to_panes(sbs, v)
            got = spmv_sbell.sbell_spmv_panes(sbs, x3).reshape(-1, 128)
            want = spmv_sbell.near_out_panes_torch(sbs, x3)
            assert_close(got, want, f"{name} shard {s} {part} vs plain",
                         TOL_PLAIN, TOL_PLAIN)
            rec[part] = {
                "n_tiles": sbs.n_tiles, "real_tiles": int(sbs.tile_ptr[-1]),
                "k_max": sbs.k_max, "n_stripes": sbs.n_stripes,
                "n_panes": sbs.n_panes, "max_abs_err_vs_plain":
                max_err(got, want),
                "graph_ms": graph_each_ms(
                    lambda: spmv_sbell.sbell_spmv_panes(sbs, x3))}
        shards.append(rec)
    rec = {"phase": "dist", "case": "dist_sbell", "matrix": name,
           "rows": m, "nnz": int(A.nnz), "build_1_shard_s": build1_s,
           "build_8_shards_s": build8_s, "has_far": d1.has_far,
           "shard_device_bytes": shard_mem, "shard_block_bytes": block_bytes,
           "shard_allocator_slack_bytes": slack,
           "far_blocks_1_shard": int(d1.far_rows.shape[1]),
           "launches_a_matvec": 2,
           "max_abs_err_vs_scipy": float(np.abs(y[:m].cpu().numpy()
                                                - oracle).max()),
           "max_abs_err_vs_sbell_spmv": max_err(y[:m], y1),
           "dist_matvec_event_ms": t_dist,
           "sbell_spmv_event_ms": t_single,
           "all_gather_event_ms": t_gather,
           "all_gather_share": t_gather / t_dist,
           "shards_8_max_abs_err_vs_scipy": float(np.abs(
               y8[:m].cpu().numpy() - oracle).max()),
           "shards_8_rows_local": rl, "shards_8": shards}
    return rec, total


def dist_paths(mesh, dev) -> int:
    """The other distributed paths on the one-rank mesh, each gated:
    DistDIA (Poisson 3072^2 + I/2: matvec, 32 CG iterations), DistCSR
    dist_cg (Poisson 1024^2 + I/2, 32 iterations), dist_blur2d_fn at
    8192^2, r = 8, overlap off and on (and bench/overlap.run),
    dist_poisson_fn, dist2d_spmv_fn on a (1, 1) mesh, dist_amg_pcg on
    spd(cant_like) (its launches counted and held to the solve's matvecs),
    dryrun_multichip(1). Returns the AMG solve's SBELL launches."""
    import numpy as np
    import scipy.sparse as sps
    import torch

    from libhpc_tpu_torch.bench import matrices, overlap
    from libhpc_tpu_torch.dryrun import dryrun_multichip
    from libhpc_tpu_torch.ops import spmv_sbell, stencil
    from libhpc_tpu_torch.parallel.dist2d import Dist2DCSR, dist2d_spmv_fn
    from libhpc_tpu_torch.parallel.dist_amg import dist_amg_pcg
    from libhpc_tpu_torch.parallel.dist_dia import (DistDIA, dist_dia_cg,
                                                    dist_dia_spmv_fn)
    from libhpc_tpu_torch.parallel.dist_spmv import (DistCSR, dist_cg,
                                                     dist_spmv_fn)
    from libhpc_tpu_torch.parallel.dist_stencil import (dist_blur2d_fn,
                                                        dist_poisson_fn)
    from libhpc_tpu_torch.parallel.mesh import make_mesh_2d

    def cg_record(system, As, build, solve):
        out = {}
        t0 = time.perf_counter()
        dA = build(As)
        build_s = time.perf_counter() - t0
        n = As.shape[0]
        x = np.linspace(-1.0, 1.0, n, dtype=np.float32)
        xd = torch.from_numpy(x).to(dev)
        mv = solve[0](dA)
        gate(mv(xd), As @ x, f"{system} matvec")
        b = torch.ones(n, device=dev)

        def run():
            out["r"] = solve[1](dA, b)

        ms = wall_ms(run)
        xs, it, _ = out["r"]
        r = np.ones(n) - As @ xs.cpu().numpy().astype(np.float64)
        if not (it == 32 and np.isfinite(r).all()
                and np.linalg.norm(r) < 1e-3 * np.sqrt(n)):
            raise AssertionError(f"{system}: {it} iterations, residual "
                                 f"{np.linalg.norm(r)}")
        emit({"phase": "dist", "case": system, "rows": n,
              "nnz": int(As.nnz), "build_s": build_s,
              "matvec_event_ms": time_ms(lambda: mv(xd)), "iterations": it,
              "ms": ms, "ms_per_iteration": ms / it,
              "residual": float(np.linalg.norm(r))})

    def shifted(A):
        return (A + sps.eye(A.shape[0], dtype=np.float32) * 0.5).tocsr()

    cg_record("dist_dia_cg poisson2d(3072)+I/2", shifted(
        matrices.poisson2d(3072)),
        lambda As: DistDIA.from_scipy(As, 1).shard(mesh),
        (lambda dA: dist_dia_spmv_fn(dA, mesh),
         lambda dA, b: dist_dia_cg(dA, b, mesh, tol=0.0, max_iter=32)))
    cg_record("dist_cg poisson2d(1024)+I/2", shifted(
        matrices.poisson2d(1024)),
        lambda As: DistCSR.from_scipy(As, 1).shard(mesh),
        (lambda dA: dist_spmv_fn(dA, mesh),
         lambda dA, b: dist_cg(dA, b, mesh, tol=0.0, max_iter=32)))

    r = 8
    a = rand_on((DENSE_N, DENSE_N), dev, DENSE_SEED + 4)
    k19 = stencil.blur2d_pallas(a, r)
    blur = {}
    for ov in (False, True):
        f = dist_blur2d_fn(mesh, radius=r, overlap=ov)
        got = f(a)
        key = "overlapped" if ov else "unoverlapped"
        assert_close(got, k19, f"dist_blur2d_fn overlap={ov} vs K19", 1e-3,
                     1e-3)
        blur[f"{key}_max_abs_err_vs_k19"] = max_err(got, k19)
    del k19
    eff = overlap.run(1, DENSE_N, DENSE_N, r, "cuda")
    u = a[:2048, :2048].contiguous()
    p5 = dist_poisson_fn(mesh)(u)
    assert_close(p5, stencil.poisson5_apply(u), "dist_poisson_fn",
                 TOL_PLAIN, TOL_PLAIN)
    emit({"phase": "dist", "case": "stencils", "blur_shape": [DENSE_N,
                                                               DENSE_N],
          "radius": r, **blur, "overlap_efficiency": eff,
          "poisson_2048_max_abs_err": max_err(p5, stencil.poisson5_apply(u)),
          "poisson_2048_event_ms": time_ms(
              lambda: dist_poisson_fn(mesh)(u))})
    del a, u, p5

    A = matrices.poisson2d(1024)
    mesh2 = make_mesh_2d(1, 1, ("py", "px"), device_type="cuda")
    d2 = Dist2DCSR.from_scipy(A, (1, 1)).shard(mesh2)
    x = np.linspace(-1.0, 1.0, A.shape[1], dtype=np.float32)
    xd = torch.from_numpy(x).to(dev)
    mv2 = dist2d_spmv_fn(d2, mesh2, realign=True)
    gate(mv2(xd), A @ x, "dist2d_spmv_fn (1, 1)")
    emit({"phase": "dist", "case": "dist2d_spmv poisson2d(1024) (1, 1)",
          "event_ms": time_ms(lambda: mv2(xd))})

    As = spd_from(matrices.load_or_synthesize("cant"))
    b = np.random.default_rng(AMG_SEED).standard_normal(As.shape[0]) \
        .astype(np.float32)
    torch.cuda.synchronize()
    spmv_sbell.SPMV_LAUNCHES = spmv_sbell.NEAR_LAUNCHES = 0
    t0 = time.perf_counter()
    xa, it, _ = dist_amg_pcg(As, mesh, 1, b, tol=1e-6, max_iter=200)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launched = (spmv_sbell.SPMV_LAUNCHES, spmv_sbell.NEAR_LAUNCHES)
    # pcg_op: it + 1 fine matvecs and it + 1 V-cycles of 4 matvecs (pre
    # = post = 2), two SBELL launches a matvec
    want = 2 * 5 * (it + 1)
    if launched != (want, 0):
        raise AssertionError(f"dist AMG-PCG: {it} iterations launched "
                             f"{launched}, expected ({want}, 0)")
    res = np.linalg.norm(b.astype(np.float64) - As @ xa[:As.shape[0]]
                         .cpu().numpy().astype(np.float64))
    limit = AMG_GATE * max(np.linalg.norm(b), 1.0)
    if not (np.isfinite(res) and res <= limit and 0 < it < 200):
        raise AssertionError(f"dist AMG-PCG: {it} iterations, true "
                             f"residual {res} > {limit}")
    single = AMG_RECORDS.get("spd(cant_like)", {})
    emit({"phase": "dist", "case": "dist_amg_pcg spd(cant_like)",
          "rows": As.shape[0], "iterations": it, "true_residual": float(res),
          "gate": float(limit), "launches": want,
          "setup_and_solve_s": solve_s,
          "amg_pcg_iterations": single.get("pcg_iterations"),
          "amg_pcg_true_residual": single.get("true_residual")})

    recs = dryrun_multichip(1)
    emit({"phase": "dist", "case": "dryrun_multichip(1)", "record": recs})
    return want


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL process group over a file store in a fresh
    directory, destroyed on the way out; yields its 1-D mesh."""
    import datetime
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from libhpc_tpu_torch.parallel.mesh import make_mesh_1d

    store = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group(
        "nccl", init_method=f"file://{store}/store", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DIST_GROUP_TIMEOUT_S))
    try:
        yield make_mesh_1d(1, device_type="cuda")
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


DIST_SPLIT_ARG = "--dist-split"


def dist_split_profile() -> dict:
    """CUPTI device time of the one-shard DistSBELL matvec on cant_like and
    pwtk_like, split into its two SBELL kernel launches, the NCCL
    all_gather and the torch ops left (the flat API's pads and pane
    transposes, the far set's far_spmv, the adds), in a process of its own
    (chip_smoke.py --dist-split): late in the main process the profiler
    loses records."""
    import numpy as np
    import torch

    from libhpc_tpu_torch.bench import matrices
    from libhpc_tpu_torch.parallel.dist_sbell import (DistSBELL,
                                                      dist_sbell_spmv_fn)

    dev = torch.device("cuda")
    out = {"phase": "dist_split"}
    with one_rank_group() as mesh:
        for name in ("cant", "pwtk"):
            A = matrices.load_or_synthesize(name)
            d1 = DistSBELL.from_scipy(A, 1).shard(mesh)
            matvec = dist_sbell_spmv_fn(d1, mesh)
            x = np.zeros(d1.shape[1], np.float32)
            x[:A.shape[1]] = np.linspace(-1.0, 1.0, A.shape[1])
            xd = torch.from_numpy(x).to(dev)
            total, split = device_ms(lambda: matvec(xd),
                                     want={"sbell_spmv_kernel": 2})
            sbell = sum(v for k, v in split.items() if "sbell_spmv" in k)
            nccl = sum(v for k, v in split.items() if "nccl" in k)
            out[f"{name}_like"] = {
                "device_ms": total, "sbell_kernels_ms": sbell,
                "all_gather_ms": nccl,
                "other_ms": total - sbell - nccl if total else None,
                "other_ops": sorted(k[:60] for k in split
                                    if "sbell_spmv" not in k
                                    and "nccl" not in k)}
    return out


def dist_split_phase() -> None:
    import torch

    torch.cuda.synchronize()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          DIST_SPLIT_ARG], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"dist_split: the profiling process failed "
                             f"({res.returncode}): {res.stderr[-3000:]}")
    emit(json.loads(res.stdout.strip().splitlines()[-1]))


def dist_phase(dev) -> int:
    """Phase 29b: the distributed layer on a one-rank NCCL process group,
    then the one-shard matvec's CUPTI split in a child process. Returns
    the SBELL kernel launches of its counted paths."""
    from libhpc_tpu_torch.bench import matrices

    t_phase = time.perf_counter()
    with one_rank_group() as mesh:
        launches = 0
        for name in ("cant", "pwtk"):
            rec, n = dist_sbell_case(f"{name}_like",
                                     matrices.load_or_synthesize(name), mesh,
                                     dev)
            emit(rec)
            launches += n
        launches += dist_paths(mesh, dev)
    dist_split_phase()
    emit({"phase": "dist", "case": "total", "sbell_launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def multigrid_phase(dev) -> None:
    """Phase 29b: geometric multigrid on (2^12 - 1)^2 and 4096^2 in float32,
    10 V-cycles each, the residual recomputed in float64 and held to the
    float32 floor: the residual of the float64 solution (10 V-cycles in
    float64) rounded to float32. The reference tests' contraction gates
    (tests/test_multigrid.py:44-51, 118-124) at 1023^2 / 1024^2, where
    float32 resolves them: at the full size one V-cycle nears the float32
    floor (the reference gives the same r1, r2 there)."""
    import numpy as np
    import torch

    from libhpc_tpu_torch.ops import multigrid as mg

    def rhs(n):
        return torch.from_numpy(np.random.default_rng(0).random(
            (n, n)).astype(np.float32)).to(dev)

    def norm64(f, op, u, h):
        return float(torch.linalg.vector_norm(f.double() - op(u.double(), h)))

    for name, k, solve, op, vc, bound in (
            ("vertex", 12, mg.mg_solve, mg.poisson_op, mg.v_cycle, 0.35),
            ("cell", 12, mg.mg_solve_cc, mg.poisson_op_cc, mg.v_cycle_cc,
             0.4)):
        rec = {"phase": "multigrid", "hierarchy": name}
        for size in (k - 2, k):
            n = (1 << size) - (name == "vertex")
            h = 1.0 / ((n + 1) if name == "vertex" else n)
            f = rhs(n)
            r1, r2 = (float(solve(f, h=h, n_cycles=c)[1]) for c in (1, 2))
            if size < k:
                if not r2 < bound * r1:
                    raise AssertionError(f"multigrid {name} {n}^2: r2 {r2} "
                                         f">= {bound} r1 {r1}")
                rec.update(gate_grid=n, gate_r1=r1, gate_r2=r2,
                           gate_contraction=r2 / r1, bound=bound)
                continue
            d1, d2 = (float(solve(f.double(), h=h, n_cycles=c)[1])
                      for c in (1, 2))
            out = {}

            def run():
                out["u"], out["res"] = solve(f, h=h, n_cycles=10)

            solve_ms = wall_ms(run, reps=2)
            res64 = norm64(f, op, out["u"], h)
            u64, _ = solve(f.double(), h=h, n_cycles=10)
            floor = norm64(f, op, u64.float(), h)
            if not (np.isfinite(res64) and res64 <= 2.0 * floor):
                raise AssertionError(f"multigrid {name} {n}^2: residual "
                                     f"{res64} after 10 cycles, float32 "
                                     f"floor {floor}")
            z = torch.zeros_like(f)
            vcycle_ms = time_ms(lambda: vc(z, f, h), warmup=1, reps=5)
            vcycle_graph_ms = graph_ms(lambda: vc(z, f, h), reps=5)
            rec.update(grid=n, r1=r1, r2=r2, contraction=r2 / r1,
                       r1_f64=d1, r2_f64=d2, contraction_f64=d2 / d1,
                       res_norm_f32=float(out["res"]), res_norm_f64=res64,
                       float32_floor_f64=floor,
                       res_rel_f64=res64 / float(torch.linalg.vector_norm(
                           f.double())),
                       solve_10_cycles_ms=solve_ms, vcycle_ms=vcycle_ms,
                       vcycle_graph_ms=vcycle_graph_ms)
        emit(rec)


def precision_phase(dev) -> None:
    """Phase 29c: compensated sum and dot on 2^26 elements against a
    float64 sum on the card (tests/test_precision.py's bounds)."""
    import torch

    from libhpc_tpu_torch.ops import precision as pr

    n = 1 << 26
    g = torch.Generator(device=dev).manual_seed(1234)
    m = n // 3
    big = torch.rand(m, generator=g, device=dev) * 1e7
    x = torch.cat([big, -big, torch.rand(n - 2 * m, generator=g,
                                         device=dev)])
    x = x[torch.randperm(n, generator=g, device=dev)]
    del big
    exact = float(x.double().sum())
    sum_bound = SUM_BOUND_REL * float(x.double().abs().sum())
    comp = float(pr.sum_compensated(x))
    plain = float(torch.sum(x))
    if not (abs(comp - exact) <= abs(plain - exact)
            and abs(comp - exact) <= sum_bound):
        raise AssertionError(f"sum_compensated: error {comp - exact} (bound "
                             f"{sum_bound}), plain {plain - exact}")
    sum_ms = time_ms(lambda: pr.sum_compensated(x), warmup=1, reps=5)
    plain_sum_ms = time_ms(lambda: torch.sum(x))
    # tests/test_precision.py's dot operands (|a| < 1e4, |c| < 1e-4), each
    # pair (a, c) kept where float32 rounds a * c down and joined by the
    # pair (-fl(a * c), 1): the rounded products cancel, and the exact dot
    # is the sum of the products' rounding errors, which two_prod carries
    # and a plain float32 dot loses. A dot without two_prod's error term
    # misses it by 100%, one without the tree's lo half by ~1%.
    half = n // 2
    a = (torch.rand(n + half, generator=g, device=dev) * 2 - 1) * 1e4
    c = (torch.rand(n + half, generator=g, device=dev) * 2 - 1) * 1e-4
    down = a.double() * c.double() > (a * c).double()
    a, c = a[down][:half], c[down][:half]
    if a.numel() < half:
        raise AssertionError(f"dot operands: {a.numel()} of {half} pairs")
    a, c = torch.cat([a, -(a * c)]), torch.cat([c, torch.ones_like(c)])
    order = torch.randperm(n, generator=g, device=dev)
    a, c = a[order], c[order]
    del down, order
    exact_d = float(torch.dot(a.double(), c.double()))
    comp_d = float(pr.dot_compensated(a, c))
    plain_d = float(torch.dot(a, c))
    rel = abs(comp_d - exact_d) / max(abs(exact_d), 1e-30)
    plain_rel = abs(plain_d - exact_d) / max(abs(exact_d), 1e-30)
    if not (rel < 1e-6 and rel <= plain_rel / 4):
        raise AssertionError(f"dot_compensated: relative error {rel} (bound "
                             f"1e-6), plain {plain_rel}")
    dot_ms = time_ms(lambda: pr.dot_compensated(a, c), warmup=1, reps=5)
    plain_dot_ms = time_ms(lambda: torch.dot(a, c))
    emit({"phase": "precision", "n": n,
          "sum_abs_err": abs(comp - exact), "plain_sum_abs_err":
          abs(plain - exact), "sum_bound": sum_bound,
          "dot_exact": exact_d, "dot_rel_err": rel,
          "plain_dot_rel_err": plain_rel,
          "dot_bound": 1e-6, "sum_compensated_ms": sum_ms,
          "torch_sum_ms": plain_sum_ms, "dot_compensated_ms": dot_ms,
          "torch_dot_ms": plain_dot_ms})


def formats_phase(dev) -> None:
    """Phase 29d: COO, BSR (8 x 8) and BELL SpMV and csr_spmv_t on
    cant_like; BandedHybrid on Poisson 1024^2; the corpus's two SpMM cases
    (corpus.py:296-326, K = 64). Each against scipy at 2e-3, with times
    beside the torch.sparse CSR product's."""
    import numpy as np
    import torch

    from libhpc_tpu_torch.bench import matrices
    from libhpc_tpu_torch.ops import spmm, spmv
    from libhpc_tpu_torch.sparse import BELL, BSR, COO, CSR, ELL
    from libhpc_tpu_torch.sparse import BandedHybrid

    A = matrices.load_or_synthesize("cant")
    m, n = A.shape
    x = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    xd = torch.from_numpy(x).to(dev)
    At = torch_csr(A, dev)
    lib_mv = time_ms(lambda: At @ xd)

    def case(name, fn, want, library_ms, **extra):
        y = fn()
        gate(y, want, name)
        emit({"phase": "formats", "case": name, "ms": time_ms(fn),
              "torch_sparse_csr_ms": library_ms,
              "max_abs_err_vs_scipy": float(np.abs(y.cpu().numpy()
                                                   - want).max()),
              **extra})

    t0 = time.perf_counter()
    coo = COO.from_scipy(A, device=dev)
    case("coo_spmv_cant", lambda: spmv.coo_spmv(coo, xd), A @ x, lib_mv,
         build_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    bsr = BSR.from_scipy(A, block=8, device=dev)
    build_bsr = time.perf_counter() - t0
    xp = torch.nn.functional.pad(xd, (0, bsr.shape[1] - n))
    case("bsr_spmv_cant", lambda: spmv.bsr_spmv(bsr, xp)[:m], A @ x, lib_mv,
         build_s=build_bsr, nblocks=bsr.nblocks,
         fill_ratio=bsr.fill_ratio())
    t0 = time.perf_counter()
    bell = BELL.from_bsr(bsr)
    case("bell_spmv_cant", lambda: spmv.bell_spmv(bell, xp)[:m], A @ x,
         lib_mv, build_s=time.perf_counter() - t0, K=bell.K,
         fill_ratio=bell.fill_ratio())
    csr = CSR.from_scipy(A, device=dev)
    yv = np.linspace(1.0, -1.0, m, dtype=np.float32)
    ATt = torch_csr(A.T, dev)
    yd = torch.from_numpy(yv).to(dev)
    case("csr_spmv_t_cant", lambda: spmv.csr_spmv_t(csr, yd), A.T @ yv,
         time_ms(lambda: ATt @ yd))
    Ap = matrices.poisson2d(1024)
    xq = np.linspace(-1.0, 1.0, Ap.shape[1], dtype=np.float32)
    xqd = torch.from_numpy(xq).to(dev)
    Apt = torch_csr(Ap, dev)
    lib_p = time_ms(lambda: Apt @ xqd)
    for rcm in (False, True):
        t0 = time.perf_counter()
        hyb = BandedHybrid.from_scipy(Ap, rcm=rcm, device=dev)
        case(f"hybrid_spmv_poisson1024_rcm{int(rcm)}",
             lambda: spmv.hybrid_spmv(hyb, xqd), Ap @ xq, lib_p,
             build_s=time.perf_counter() - t0, coverage=hyb.coverage,
             band_diags=hyb.band.ndiags, rest_k=hyb.rest.k)
    # SpMM, K = 64 (corpus.py:296-326)
    rng = np.random.default_rng(7)
    A5 = matrices.poisson2d(512)
    ell = ELL.from_csr(CSR.from_scipy(A5, device="cpu")).to(dev)
    X = rng.standard_normal((A5.shape[1], 64)).astype(np.float32)
    Xd = torch.from_numpy(X).to(dev)
    A5t = torch_csr(A5, dev)
    case("spmm_ell_poisson512_k64", lambda: spmm.ell_spmm(ell, Xd), A5 @ X,
         time_ms(lambda: A5t @ Xd))
    Xu = rng.standard_normal((bsr.shape[1], 64)).astype(np.float32)
    Xud = torch.from_numpy(Xu).to(dev)
    Aup = A.copy()
    Aup.resize(bsr.shape)
    Aupt = torch_csr(Aup, dev)
    case("spmm_bsr_cant_k64", lambda: spmm.bsr_spmm(bsr, Xud), Aup @ Xu,
         time_ms(lambda: Aupt @ Xud))


SPGEMM_WINDOW = 1 << 22   # spgemm_pwtk_10m's window (bench.py:685-712)
SPGEMM_GATE = 1e-2        # max |C - A A| of the reference's SpGEMM cases


def assert_no_tf32(what: str) -> None:
    import torch

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError(f"{what}: a TF32 flag is on")


def csr_on_card(C, dev):
    """scipy CSR C as device (row, col, data) int64 / int64 / float32."""
    import numpy as np
    import torch

    C = C.tocsr()
    C.sort_indices()
    rows = torch.repeat_interleave(
        torch.arange(C.shape[0], device=dev),
        torch.from_numpy(np.diff(C.indptr).astype(np.int64)).to(dev))
    return (rows, torch.from_numpy(C.indices.astype(np.int64)).to(dev),
            torch.from_numpy(C.data.astype(np.float32)).to(dev))


def gate_triplets(row, col, data, ref, ncols: int, what: str) -> dict:
    """Device (row, col, data) of a product with ncols columns (explicit
    zeros and duplicates allowed) against ref = csr_on_card of scipy's, as
    the reference's gates compare: max |C - A A| over the union of their
    entries < SPGEMM_GATE. Returns {nnz: C's nonzero entries,
    max_abs_err}."""
    import torch

    key = torch.cat([row.long() * ncols + col.long(),
                     ref[0] * ncols + ref[1]])
    val = torch.cat([data.float(), -ref[2]])
    uniq, inv = torch.unique(key, return_inverse=True)
    diff = torch.zeros(uniq.numel(), device=val.device).index_add_(0, inv,
                                                                    val)
    err = float(diff.abs().max()) if diff.numel() else 0.0
    if not err < SPGEMM_GATE:
        raise AssertionError(f"{what}: max |C - A A| {err} >= {SPGEMM_GATE}")
    return {"nnz": int((data != 0).sum()), "max_abs_err": err}


def timed_stages(module, host_names, device_name, record):
    """Wrap module functions for one call of an entry point: host seconds
    of each of host_names (and of device_name's enqueue) summed into
    record[name], and CUDA events around each call of device_name in
    record["events"]. Returns a function that puts the originals back."""
    import torch

    saved = {n: getattr(module, n) for n in (*host_names, device_name)}

    def host(name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                record[name] = (record.get(name, 0.0)
                                + time.perf_counter() - t0)
        return wrapped

    def device(fn):
        def wrapped(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            record.setdefault("events", []).append((start, end))
            return out
        return wrapped

    for n in host_names:
        setattr(module, n, host(n, saved[n]))
    setattr(module, device_name, host(device_name,
                                      device(saved[device_name])))

    def restore():
        for n, fn in saved.items():
            setattr(module, n, fn)
    return restore


def spgemm_library_ms(A, dev) -> dict:
    """torch.sparse.mm of A's float32 torch.sparse CSR by itself on the
    card (cuSPARSE SpGEMM): the library yardstick, used nowhere in the
    port. A RuntimeError of the library is recorded, not raised."""
    import torch

    At = torch_csr(A, dev)
    try:
        ms = time_ms(lambda: torch.sparse.mm(At, At), warmup=1, reps=3)
        nnz = int(torch.sparse.mm(At, At)._nnz())
    except RuntimeError as e:
        return {"torch_sparse_mm_error": str(e)[:200]}
    finally:
        torch.cuda.synchronize()
    return {"torch_sparse_mm_ms": ms, "torch_sparse_mm_nnz": nnz}


def spgemm_phase(dev) -> None:
    """Phase 29e: SpGEMM (ops/spgemm.py, ops/spgemm_bsr.py; torch ops, no
    kernel of their own). pwtk_like A @ A: windowed at 2^22 slots a window
    (the reference's spgemm_pwtk_10m) and on 8 x 8 blocks, mxu and not
    (spgemm_block_pwtk); cant_like: spgemm, spgemm_csr, spgemm_blocked
    (row_block 4096). Each against scipy's product (max |C - A A| < 1e-2
    over both entry sets; the windowed form also with scipy's nnz), with
    times beside torch.sparse.mm's."""
    import numpy as np
    import torch

    from libhpc_tpu_torch.bench import matrices
    from libhpc_tpu_torch.ops import spgemm, spgemm_bsr
    from libhpc_tpu_torch.sparse import BSR, CSR

    assert_no_tf32("spgemm")
    A = matrices.load_or_synthesize("pwtk")
    t0 = time.perf_counter()
    ref = csr_on_card(A @ A, dev)
    scipy_s = time.perf_counter() - t0
    Ac = CSR.from_scipy(A, device=dev)
    S = spgemm.spgemm_expansion_size(Ac, Ac)
    lenB = np.diff(A.indptr).astype(np.int64)
    if S != int(lenB[A.indices].sum()):
        raise AssertionError(f"spgemm_expansion_size {S}")
    small = CSR.from_scipy(matrices.poisson2d(32), device=dev)
    spgemm.spgemm_windowed(small, small, window=1 << 12)     # warm
    rec = {}
    restore = timed_stages(spgemm, ("_symbolic_windows", "_prep_batch",
                                    "_pull_batch", "_merge_seams"),
                           "_spgemm_window", rec)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C = spgemm.spgemm_windowed(Ac, Ac, window=SPGEMM_WINDOW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    device_s = sum(s.elapsed_time(e) for s, e in rec["events"]) / 1e3
    if C.nnz != ref[0].numel():
        raise AssertionError(f"spgemm_pwtk_10m: nnz {C.nnz} against "
                             f"scipy's {ref[0].numel()}")
    g = gate_triplets(C.row, C.col, C.data, ref, A.shape[1],
                      "spgemm_pwtk_10m")
    emit({"phase": "spgemm", "case": "spgemm_pwtk_10m",
          "window": SPGEMM_WINDOW, "seconds": wall,
          "g_products_per_s": S / wall / 1e9, "expansion": S,
          "nnz_a": int(A.nnz), "nnz_c": g["nnz"],
          "windows": -(-S // SPGEMM_WINDOW), "batches": len(rec["events"]),
          "device_s": device_s,
          "host_symbolic_s": rec["_symbolic_windows"],
          "host_prep_s": rec["_prep_batch"],
          "enqueue_s": rec["_spgemm_window"],
          "pull_s": rec["_pull_batch"], "host_merge_s": rec["_merge_seams"],
          "max_abs_err": g["max_abs_err"], "scipy_product_s": scipy_s,
          **spgemm_library_ms(A, dev)})
    del C, Ac, small

    Ab = BSR.from_scipy(A, block=8, device=dev)
    if Ab.shape != A.shape:
        raise AssertionError(f"pwtk_like is not a multiple of 8: {A.shape}")
    for mxu in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Cb = spgemm_bsr.spgemm_bsr(Ab, Ab, mxu=mxu)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b = Cb.b
        rows = (Cb.block_row_of_block().long()[:, None, None] * b
                + torch.arange(b, device=dev)[None, :, None]).expand(
                    -1, b, b)
        cols = (Cb.indices.long()[:, None, None] * b
                + torch.arange(b, device=dev)[None, None, :]).expand(
                    -1, b, b)
        g = gate_triplets(rows.reshape(-1), cols.reshape(-1),
                          Cb.blocks.reshape(-1), ref, A.shape[1],
                          f"spgemm_block_pwtk mxu={mxu}")
        # the numeric pass alone: one call replayed from a CUDA graph
        t0 = time.perf_counter()
        ai = Ab.indices.cpu().numpy().astype(np.int64)
        ap = Ab.indptr.cpu().numpy().astype(np.int64)
        ia, ib, seg, out_r, _ = spgemm_bsr._symbolic(ai, ap, ai, ap,
                                                     Ab.shape[1] // b)
        symbolic_s = time.perf_counter() - t0
        P, n_out = ia.size, out_r.size
        iad, ibd, segd = (torch.from_numpy(v).to(dev) for v in (ia, ib, seg))
        blocks = Ab.blocks.float()
        acc = torch.zeros((n_out, b, b), device=dev)

        def numeric():
            acc.zero_()
            for p0 in range(0, P, spgemm_bsr.PAIR_CHUNK):
                p1 = min(P, p0 + spgemm_bsr.PAIR_CHUNK)
                spgemm_bsr._numeric_chunk(blocks, blocks, iad[p0:p1],
                                          ibd[p0:p1], segd[p0:p1], acc,
                                          n_out=n_out, mxu=mxu, bsz=b)

        dev_ms = graph_ms(numeric)
        emit({"phase": "spgemm", "case": "spgemm_block_pwtk", "mxu": mxu,
              "wall_s": wall, "host_symbolic_s": symbolic_s,
              "device_ms": dev_ms,
              "g_products_per_s_wall": S / wall / 1e9,
              "g_products_per_s_device": S / (dev_ms * 1e-3) / 1e9,
              "pairs": int(P), "nnzb_c": int(n_out), "nnz_c": g["nnz"],
              "max_abs_err": g["max_abs_err"]})
        del Cb, rows, cols, iad, ibd, segd, acc, blocks
    del Ab, ref, A

    # spgemm / spgemm_csr / spgemm_blocked on cant_like: the ELL expansion
    # nnzA x kB must fit the card (about 60 bytes a slot through the sort
    # and the segment sums), else spgemm alone runs on Poisson 1024^2
    A = matrices.load_or_synthesize("cant")
    kB = max(1, -(-int(np.diff(A.indptr).max()) // 8) * 8)
    expansion = A.nnz * kB
    free = torch.cuda.mem_get_info()[0]
    fits = expansion * 60 < free
    emit({"phase": "spgemm", "case": "cant_like_ell_expansion",
          "nnz_a": int(A.nnz), "kB": kB, "ell_expansion": expansion,
          "exact_expansion": int(np.diff(A.indptr)[A.indices].sum()),
          "free_bytes": free, "fits": fits})
    if not fits:
        A = matrices.poisson2d(1024)
        print("spgemm: cant_like's ELL expansion does not fit the card; "
              "spgemm runs on Poisson 1024^2 instead", flush=True)
    name = "cant_like" if fits else "poisson1024"
    ref = csr_on_card(A @ A, dev)
    lib = spgemm_library_ms(A, dev)
    Ac = CSR.from_scipy(A, device=dev)
    cases = {"spgemm": lambda: spgemm.spgemm(Ac, Ac)}
    if fits:
        cases["spgemm_csr"] = lambda: spgemm.spgemm_csr(Ac, Ac)
        cases["spgemm_blocked"] = lambda: spgemm.spgemm_blocked(Ac, Ac)
    for case, fn in cases.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = C.row_of_nnz() if case == "spgemm_csr" else C.row
        col = C.indices if case == "spgemm_csr" else C.col
        g = gate_triplets(row, col, C.data, ref, A.shape[1],
                          f"{case} {name}")
        emit({"phase": "spgemm", "case": f"{case}_{name}", "seconds": wall,
              "slots": int(C.nnz), "nnz_c": g["nnz"],
              "max_abs_err": g["max_abs_err"], **lib})
        del C, row, col
    assert_no_tf32("spgemm")


def runtime_phase(dev, native_build) -> None:
    """Phase 29f: the utilities and the native runtime on the card: the
    native library's build (started beside the phases before) and
    self-test, an ArenaPool round trip, cant_like through a MatrixMarket
    file -> load_mtx_native (equal to scipy.io.mmread) -> SBELL -> one
    fused SpMV (against scipy), the host Morton encode against
    utils/morton, a CG checkpoint resumed on the card, the CSR checks on a
    good and a corrupted CUDA CSR, and a trace of a CG solve naming its
    annotate range."""
    import dataclasses
    import glob
    import tempfile

    import numpy as np
    import scipy.io as sio
    import torch

    from libhpc_tpu_torch.bench import matrices
    from libhpc_tpu_torch.ops import solver, spmv_sbell
    from libhpc_tpu_torch.runtime import native
    from libhpc_tpu_torch.sparse import CSR
    from libhpc_tpu_torch.sparse.sbell import SBELL
    from libhpc_tpu_torch.utils import checkpoint, profiling, validate
    from libhpc_tpu_torch.utils.morton import morton2d_encode

    build_s = native_build.result()
    t0 = time.perf_counter()
    native.get_lib()
    load_s = time.perf_counter() - t0
    rc = native.selftest()
    if rc != 0:
        raise AssertionError(f"native selftest returned {rc}")
    pool = native.ArenaPool(page_size=4096)
    ptrs = [pool.alloc(100) for _ in range(64)]
    big = pool.alloc(1 << 16)
    if any(p % 16 for p in ptrs) or not pool.free_large(big):
        raise AssertionError("ArenaPool: misaligned or large free failed")
    pool.reset()
    pages = pool.n_pages
    pool.close()

    A = matrices.load_or_synthesize("cant")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cant.mtx")
        t0 = time.perf_counter()
        sio.mmwrite(path, A)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        L = native.load_mtx_native(path)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        M = sio.mmread(path).tocsr()
        mmread_s = time.perf_counter() - t0
        M.sort_indices()
        if not (np.array_equal(L.indptr, M.indptr)
                and np.array_equal(L.indices, M.indices)
                and np.allclose(L.data, M.data, rtol=1e-6, atol=0)):
            raise AssertionError("load_mtx_native differs from mmread")
        t0 = time.perf_counter()
        sb = SBELL.from_scipy(L, device=dev)
        sbell_s = time.perf_counter() - t0
        x = np.linspace(-1.0, 1.0, L.shape[1], dtype=np.float32)
        spmv_sbell.SPMV_LAUNCHES = 0
        y = spmv_sbell.sbell_spmv(sb, torch.from_numpy(x).to(dev))
        torch.cuda.synchronize()
        spmv_launches = spmv_sbell.SPMV_LAUNCHES
        if spmv_launches != 1:
            raise AssertionError(f"the loaded matrix's SpMV launched the "
                                 f"fused kernel {spmv_launches} times")
        gate(y[:L.shape[0]], L @ x, "load_mtx_native -> SBELL SpMV")
    del sb, y

    rng = np.random.default_rng(3)
    mx = rng.integers(0, 1 << 16, 1 << 20).astype(np.uint32)
    my = rng.integers(0, 1 << 16, 1 << 20).astype(np.uint32)
    host = native.morton2d_encode_host(mx, my)
    card = morton2d_encode(torch.from_numpy(mx.view(np.int32)).to(dev).long(),
                           torch.from_numpy(my.view(np.int32)).to(dev).long(),
                           device=dev)
    if not np.array_equal(host, card.cpu().numpy()):
        raise AssertionError("morton2d_encode_host differs from "
                             "utils/morton on the card")

    # a CG on spd(cant_like) through the fused SBELL SpMV (one CTA a
    # stripe: deterministic), checkpointed after 20 iterations
    As = spd_from(A)
    sbs = SBELL.from_scipy(As, device=dev)
    b = np.zeros(sbs.n_panes * 1024, np.float32)
    b[:As.shape[0]] = 1.0
    b3 = spmv_sbell.x_to_panes(sbs, torch.from_numpy(b).to(dev))

    def mv(u):
        return spmv_sbell.sbell_spmv_panes(sbs, u)

    x1, it1, _ = solver.cg(mv, b3, tol=1e-10, max_iter=20)
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "cg.npz")
        checkpoint.save(p, {"x": x1, "it": it1})
        back = checkpoint.restore(p, {"x": x1, "it": it1})
        x1b = back["x"]
        if x1b.device != x1.device or not torch.equal(x1b, x1):
            raise AssertionError("checkpoint: x did not come back on the "
                                 "card unchanged")
        x2a, _, _ = solver.cg(mv, b3, x0=x1, tol=1e-10, max_iter=20)
        x2b, _, _ = solver.cg(mv, b3, x0=x1b, tol=1e-10, max_iter=20)
        torch.testing.assert_close(x2b, x2a, rtol=1e-6, atol=0)
        resume_err = float((x2b - x2a).abs().max())

        csr = CSR.from_scipy(A, device=dev)
        err, _ = validate.csr_invariants_checked(csr)
        if err.get() is not None:
            raise AssertionError(f"good CSR failed: {err.get()}")
        bad = dataclasses.replace(csr, indptr=csr.indptr.clone())
        bad.indptr[7] = bad.indptr[9] + 1
        err, _ = validate.csr_invariants_checked(bad)
        if err.get() != "indptr not monotone":
            raise AssertionError(f"corrupted CSR: {err.get()}")

        logdir = os.path.join(tmp, "trace")
        with profiling.trace_to(logdir):
            with profiling.annotate("cg"):
                _, it_t, _ = solver.cg(mv, b3, tol=1e-5)
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(logdir, "*.json"))
        names = set()
        for f in files:
            with open(f) as fh:
                names |= {e.get("name") for e in json.load(fh)["traceEvents"]}
        kernels_traced = sum(1 for n in names if n and "sbell_spmv" in n)
        if "cg" not in names:
            raise AssertionError(f"trace_to wrote {len(files)} files "
                                 "without the annotate range 'cg'")
    emit({"phase": "runtime", "native_build_s": build_s,
          "native_load_s": load_s, "selftest": rc, "pool_pages": pages,
          "mtx_nnz": int(L.nnz), "mmwrite_s": write_s,
          "load_mtx_native_s": native_s, "mmread_s": mmread_s,
          "sbell_build_s": sbell_s, "spmv_launches": spmv_launches,
          "morton_codes": int(mx.size), "cg_checkpoint_iterations": it1,
          "resume_max_abs_diff": resume_err, "trace_files": len(files),
          "trace_cg_iterations": it_t,
          "trace_sbell_kernel_names": kernels_traced})


def hold(kind, case, kernel, plain, kernel_times):
    """A kernel against its plain version on the same inputs (TOL_PLAIN),
    then the device time of each (CUDA events where the profiler saw
    nothing), back to back, so an operand that fits the 50 MB L2 is read
    from it. Records (ms, plain_ms, max_abs_err) and returns them with the
    kernel's time when the L2 is flushed before each call."""
    got, want = kernel(), plain()
    assert_close(got, want, f"{case}: {kind} kernel vs plain", TOL_PLAIN,
                 TOL_PLAIN)
    ms = device_ms(kernel)[0] or time_ms(kernel)
    plain_ms = device_ms(plain)[0] or time_ms(plain)
    kernel_times[kind][case] = (ms, plain_ms, max_err(got, want))
    return (*kernel_times[kind][case], cold_device_ms(kernel))


def spmv_times(fn):
    """{device_ms, event_ms} of one whole matvec through the entry point."""
    return {"spmv_device_ms": device_ms(fn)[0], "spmv_event_ms": time_ms(fn)}


def dia_phase(A, dev, kernel_times, launches):
    """auto_format(Poisson 3072^2) -> DiaPallas; its matvec and the probe
    (the path), then K4 and K5 against their plain versions, with times."""
    import numpy as np
    import torch

    from libhpc_tpu_torch.ops import spmv_dia
    from libhpc_tpu_torch.sparse.auto import auto_format

    t0 = time.perf_counter()
    dp, matvec = auto_format(A)
    build_s = time.perf_counter() - t0
    if not isinstance(dp, spmv_dia.DiaPallas):
        raise AssertionError(f"poisson3072 routed to {type(dp).__name__}")
    dflat_bytes = dp.dflat.numel() * 4
    if (dp.n_tiles, dp.T) != (72, 1 << 17) or not (
            185e6 < dflat_bytes < 195e6 and 260e6 < dp.hbm_bytes < 272e6):
        raise AssertionError(f"DiaPallas: {dp.n_tiles} tiles at T={dp.T}, "
                             f"dflat {dflat_bytes} B, {dp.hbm_bytes} B")
    dpd = dp.to(dev)
    m, n = A.shape
    x = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    xd = torch.from_numpy(x).to(dev)

    spmv_dia.DIA_LAUNCHES = 0
    spmv_dia.PROBE_LAUNCHES = 0
    y = matvec(dpd, xd)
    probe = spmv_dia.dia_pattern_probe(dpd, xd)
    torch.cuda.synchronize()
    launches["dia"] = {"dia": spmv_dia.DIA_LAUNCHES, "matvecs": 1,
                       "dia_probe": spmv_dia.PROBE_LAUNCHES, "probes": 1}
    gate(y, A @ x, "poisson3072 dia_spmv_pallas")
    if not bool(torch.isfinite(probe).all()):
        raise AssertionError("poisson3072 probe: non-finite output")

    x_ext = spmv_dia.extend_x(dpd, xd)
    moved = nbytes(dpd.dflat, x_ext, y) + (dp.n_tiles * dp.T - m) * 4
    WORK[("dia", "poisson3072")] = (moved, 2 * dpd.dflat.numel())
    WORK[("dia_probe", "poisson3072")] = (moved, dpd.dflat.numel())
    t_k, t_kp, e_k, c_k = hold("dia", "poisson3072",
                          lambda: spmv_dia.dia_out(dpd, x_ext),
                          lambda: spmv_dia.dia_out_torch(dpd, x_ext),
                          kernel_times)
    t_p, t_pp, e_p, c_p = hold("dia_probe", "poisson3072",
                          lambda: spmv_dia.dia_probe_out(dpd, x_ext),
                          lambda: spmv_dia.dia_probe_out_torch(dpd, x_ext),
                          kernel_times)
    emit({"phase": "dia", "matrix": "poisson2d(3072)", "rows": m,
          "nnz": int(A.nnz), "container": "DiaPallas",
          "auto_format_s": build_s, "n_tiles": dp.n_tiles, "T": dp.T,
          "dflat_bytes": dflat_bytes, "hbm_bytes": dp.hbm_bytes,
          "max_abs_err_vs_scipy": float(np.abs(y.cpu().numpy()
                                               - A @ x).max()),
          "kernel_max_abs_err_vs_plain": e_k,
          "probe_max_abs_err_vs_plain": e_p,
          "kernel_device_ms": t_k, "kernel_plain_device_ms": t_kp,
          "probe_device_ms": t_p, "probe_plain_device_ms": t_pp,
          "kernel_cold_l2_device_ms": c_k, "probe_cold_l2_device_ms": c_p,
          "kernel_gb_per_s": dp.hbm_bytes / (t_k * 1e-3) / 1e9,
          "probe_gb_per_s": dp.hbm_bytes / (t_p * 1e-3) / 1e9,
          "kernel_cold_l2_gb_per_s": (dp.hbm_bytes / (c_k * 1e-3) / 1e9
                                      if c_k else None),
          "fraction_probe_over_kernel": t_p / t_k,
          "fraction_cold_l2": c_p / c_k if c_k and c_p else None,
          "gnnz_per_s": A.nnz / (t_k * 1e-3) / 1e9,
          **spmv_times(lambda: matvec(dpd, xd))})


def dia_cg_phase(A, dev, launches):
    """32 CG iterations through K4 on auto_format(A + I/2)."""
    import numpy as np
    import scipy.sparse as sps
    import torch

    from libhpc_tpu_torch.ops import cg_vectors, solver, spmv_dia
    from libhpc_tpu_torch.sparse.auto import auto_format

    As = (A + sps.eye(A.shape[0], dtype=np.float32) * 0.5).tocsr()
    dp, matvec = auto_format(As)
    if not isinstance(dp, spmv_dia.DiaPallas):
        raise AssertionError(f"poisson3072+I/2 routed to {type(dp).__name__}")
    dpd = dp.to(dev)
    n = As.shape[0]
    b = torch.ones(n, device=dev)
    n_it = 32
    calls = [0]
    out = {}

    def mv(u):
        calls[0] += 1
        return matvec(dpd, u)

    def run():
        out["r"] = solver.cg(mv, b, tol=0.0, max_iter=n_it)

    spmv_dia.DIA_LAUNCHES = 0
    cg_vectors.CG_VECTOR_LAUNCHES = 0
    ms = wall_ms(run)
    launches["dia_cg"] = {"dia": spmv_dia.DIA_LAUNCHES, "matvecs": calls[0],
                          "cg_vectors": cg_vectors.CG_VECTOR_LAUNCHES}
    solves = calls[0] // (n_it + 1)     # a solve: n_it + 1 matvecs
    if cg_vectors.CG_VECTOR_LAUNCHES != 3 * n_it * solves:
        raise AssertionError(f"DIA CG: {cg_vectors.CG_VECTOR_LAUNCHES} "
                             f"vector launches in {solves} solves")
    x, it, _ = out["r"]
    r = np.ones(n) - As @ x.cpu().numpy().astype(np.float64)
    if not (it == n_it and np.isfinite(r).all()
            and np.linalg.norm(r) < 1e-3 * np.sqrt(n)):
        raise AssertionError(f"DIA CG: {it} iterations, residual "
                             f"{np.linalg.norm(r)}")
    emit({"phase": "dia_cg", "system": "poisson2d(3072)+I/2", "rows": n,
          "nnz": int(As.nnz), "iterations": it, "ms": ms,
          "ms_per_iteration": ms / it, "residual": float(np.linalg.norm(r)),
          "gnnz_per_s": it * As.nnz / (ms * 1e-3) / 1e9})


def cg_vectors_phase(dev, kernel_times, launches):
    """One CG iteration's vector work on 2^24 float32 entries (the vectors
    of HPCG at 256^3): csrc/cg_vectors.cu's three kernels against their
    plain versions and float64; device times of the kernels, of the plain
    steps and of the aten expressions the loop ran before them (the
    library yardstick), beside 11 vector passes over 3.35 TB/s."""
    import torch

    from libhpc_tpu_torch.ops import cg_vectors

    n, case = 1 << 24, "2^24/float32"
    g = torch.Generator(device=dev).manual_seed(22)
    x, r, p, noise = (torch.randn(n, generator=g, device=dev)
                      for _ in range(4))
    Ap = 2.0 * p + 0.1 * noise
    del noise
    rs = cg_vectors.sdot(r, r)
    want64 = [v.double() for v in (x, r, p)]
    ws, wp = cg_vectors.Workspace(r, rs), cg_vectors.Workspace(r, rs)
    plain = [v.clone() for v in (x, r, p)]
    cg_vectors.CG_VECTOR_LAUNCHES = 0
    cg_vectors.dot_pAp(p, Ap, ws)
    cg_vectors.update_xr(x, r, p, Ap, ws)
    cg_vectors.update_p(p, r, ws)
    # the one iteration's launches, before any timing or graph capture
    launches["cg_vectors"] = {"cg_vectors": cg_vectors.CG_VECTOR_LAUNCHES}
    if cg_vectors.CG_VECTOR_LAUNCHES != 3:
        raise AssertionError(f"cg_vectors: {cg_vectors.CG_VECTOR_LAUNCHES} "
                             "launches for one iteration")
    xp, rp, pp = plain
    cg_vectors.dot_pAp_torch(pp, Ap, wp)
    cg_vectors.update_xr_torch(xp, rp, pp, Ap, wp)
    cg_vectors.update_p_torch(pp, rp, wp)
    # float64 of the same iteration
    x64, r64, p64 = want64
    A64 = Ap.double()
    alpha = float(r64 @ r64) / float(p64 @ A64)
    rs64 = float(r64 @ r64)
    x64 = x64 + alpha * p64
    r64 = r64 - alpha * A64
    rs_new64 = float(r64 @ r64)
    p64 = r64 + (rs_new64 / rs64) * p64
    torch.cuda.synchronize()
    err = 0.0
    for got, ref, want in ((x, xp, x64), (r, rp, r64), (p, pp, p64)):
        scale = float(want.abs().max())
        e_plain = float((got - ref).abs().max())
        if e_plain > TOL_PLAIN * scale:
            raise AssertionError(f"cg_vectors: {e_plain} from the plain "
                                 f"steps at max |v| {scale}")
        if float((got.double() - want).abs().max()) > TOL_PLAIN * scale:
            raise AssertionError("cg_vectors: off float64's iteration")
        err = max(err, e_plain)
    rel = {k: abs(float(ws.state[i]) / v - 1) for k, i, v in (
        ("rs", cg_vectors.RS, rs_new64),
        ("beta", cg_vectors.BETA, rs_new64 / rs64))}
    if max(rel.values()) > TOL_PLAIN or int(ws.ticket) != 0:
        raise AssertionError(f"cg_vectors: scalars off float64 {rel}, "
                             f"ticket {int(ws.ticket)}")

    def kernels():
        cg_vectors.dot_pAp(p, Ap, ws)
        cg_vectors.update_xr(x, r, p, Ap, ws)
        cg_vectors.update_p(p, r, ws)

    def plain_steps():
        cg_vectors.dot_pAp_torch(pp, Ap, wp)
        cg_vectors.update_xr_torch(xp, rp, pp, Ap, wp)
        cg_vectors.update_p_torch(pp, rp, wp)

    def aten():
        alpha = rs / torch.sum(pp * Ap)
        x2 = xp + alpha * pp
        r2 = rp - alpha * Ap
        rs_new = torch.sum(r2 * r2)
        return x2, r2, r2 + (rs_new / rs) * pp

    # CUPTI, or graph replay where three profiles in a row were lossy
    want = {"cg_dot_pAp": 1, "cg_update_xr": 1, "cg_update_p": 1}
    ms, split = device_ms(kernels, want=want)
    plain_ms, _ = device_ms(plain_steps)
    aten_ms, aten_split = device_ms(aten)
    timed_by = {k: "cupti" if v else "graph" for k, v in (
        ("kernels", ms), ("plain", plain_ms), ("aten", aten_ms))}
    ms = ms or graph_ms(kernels)
    plain_ms = plain_ms or graph_ms(plain_steps)
    aten_ms = aten_ms or graph_ms(aten)
    nbytes = 11 * 4 * n
    WORK[("cg_vectors", case)] = (nbytes, 10 * n)
    LIBRARY_MS["cg_vectors"] = aten_ms
    kernel_times["cg_vectors"][case] = (ms, plain_ms, err)
    emit({"phase": "cg_vectors", "n": n, "dtype": "float32",
          "max_abs_err_vs_plain": err, "scalar_rel_err_vs_f64": rel,
          "timed_by": timed_by, "ms": ms, "kernel_ms": split,
          "events_ms": time_ms(kernels),
          "plain_ms": plain_ms, "aten_ms": aten_ms,
          "aten_kernel_ms": aten_split,
          "bound_ms": nbytes / PEAK_BYTES_S * 1e3,
          "gb_per_s": nbytes / (ms * 1e-3) / 1e9})


def symgs_phase(dev, kernel_times, launches):
    """HPCG's V-cycle at 256^3 on the card: the SymGS kernel on every level
    against its plain version, one V-cycle against the plain path on the
    host and its launches, and the kernel's device times."""
    import torch

    from hpcbench import spec
    from libhpc_tpu_torch.ops import multigrid_dia, spmv_dia, symgs_dia

    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "hpcbench", "configs", "hpcg_mg_256")
    with open(conf + ".json") as f:
        cfg = json.load(f)
    inp = spec.load_file(conf + ".py").make_inputs(cfg, 0)
    grids = [tuple(g) for g in inp.sizes["grids"]]
    t0 = time.perf_counter()
    h = multigrid_dia.DiaMultigrid.from_scipy(inp.matrix, grids, device=dev)
    build_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(25)
    one_sweep = {"symgs_colour_kernel": 8}
    errs, sweep_ms = {}, {}
    for lv in h.levels:
        case = f"{lv.grid[0]}^3"
        P, n = lv.dp.x_pad_lo, lv.rows
        got = torch.zeros(spmv_dia.x_ext_len(lv.dp), device=dev)
        got[P:P + n] = torch.randn(n, generator=g, device=dev)
        r = torch.randn(n, generator=g, device=dev)
        want, abs_err = got.clone(), 0.0
        for colours in (symgs_dia.FORWARD, symgs_dia.BACKWARD):
            symgs_dia.sweep(lv.dp, lv.grid, got, r, colours)
            symgs_dia.sweep_torch(lv.dp, lv.grid, want, r, colours)
            err = max_err(got, want) / float(want.abs().max())
            if not err <= TOL_SWEEP:
                raise AssertionError(f"symgs {case}: {err} of max |x| from "
                                     "sweep_torch")
            errs[case] = max(errs.get(case, 0.0), err)
            abs_err = max(abs_err, max_err(got, want))
            want.copy_(got)

        def sweep(lv=lv, x=got, r=r, colours=symgs_dia.FORWARD):
            symgs_dia.sweep(lv.dp, lv.grid, x, r, colours)

        sweep_ms[case] = device_ms(sweep, want=one_sweep)[0] or time_ms(sweep)
        if lv is h.levels[0]:
            fine = (lv, got, r, abs_err)

    lv, x, r, err = fine
    case, rows = f"{lv.grid[0]}^3", lv.rows

    def colour0():
        symgs_dia.sweep(lv.dp, lv.grid, x, r, (0,))

    def plain():
        symgs_dia.sweep_torch(lv.dp, lv.grid, x, r, symgs_dia.FORWARD)

    colour_ms = (device_ms(colour0, want={"symgs_colour_kernel": 1})[0]
                 or time_ms(colour0))
    plain_ms = device_ms(plain)[0] or time_ms(plain)
    # the least bytes of a sweep as hpcbench/roofline_mg.py counts them:
    # 27 plane values, r and x read and x written, a row
    WORK[("symgs", case)] = (30 * rows * 4, 2 * 27 * rows)
    kernel_times["symgs"][case] = (sweep_ms[case], plain_ms, err)

    # one V-cycle: 4 sweeps on each of three levels, 2 on the coarsest,
    # 8 launches a sweep; a K4 residual on each level but the coarsest
    b = torch.randn(inp.shape[0], generator=g, device=dev)
    symgs_dia.SYMGS_LAUNCHES = 0
    multigrid_dia.MG_VCYCLES = 0
    spmv_dia.DIA_LAUNCHES = 0
    z = multigrid_dia.vcycle(h, b)
    torch.cuda.synchronize()
    counted = (symgs_dia.SYMGS_LAUNCHES, multigrid_dia.MG_VCYCLES,
               spmv_dia.DIA_LAUNCHES)
    launches["symgs"] = {"symgs": counted[0], "vcycles": counted[1],
                         "dia": counted[2], "matvecs": 3,
                         "need": {"symgs": 8 * (4 * 3 + 2), "vcycles": 1}}
    if counted != (112, 1, 3):
        raise AssertionError(f"a V-cycle launched (SymGS, V-cycles, K4) "
                             f"{counted}, expected (112, 1, 3)")
    t0 = time.perf_counter()
    host = multigrid_dia.DiaMultigrid.from_scipy(inp.matrix, grids,
                                                 device="cpu")
    want = multigrid_dia.vcycle(host, b.cpu())
    host_s = time.perf_counter() - t0
    del host
    vc_err = max_err(z.cpu(), want) / float(want.abs().max())
    if not vc_err <= TOL_VCYCLE:
        raise AssertionError(f"V-cycle 256^3: {vc_err} of max |z| from the "
                             "plain path")

    def vcycle():
        multigrid_dia.vcycle(h, b)

    vc_ms = (device_ms(vcycle, want={"symgs_colour_kernel": 112})[0]
             or time_ms(vcycle))
    bound_ms = 30 * rows * 4 / PEAK_BYTES_S * 1e3
    emit({"phase": "symgs", "grids": grids, "build_s": build_s,
          "plane_bytes": sum(nbytes(lv.dp.dflat) for lv in h.levels),
          "max_rel_err_vs_plain": errs,
          "vcycle_max_rel_err_vs_plain_host": vc_err,
          "plain_host_vcycle_s": host_s,
          "launches_a_vcycle": launches["symgs"],
          "sweep_device_ms": sweep_ms, "colour0_device_ms": colour_ms,
          "sweep_plain_device_ms": plain_ms, "sweep_bound_ms": bound_ms,
          "sweep_pct_of_bound": 100 * bound_ms / sweep_ms[case],
          "vcycle_device_ms": vc_ms, "vcycle_event_ms": time_ms(vcycle)})
    del h, inp


def dia_xla_phase(dev):
    """auto_format(Poisson 1024^2) -> DIA (plain dia_spmv), then
    cg_dia_poisson1024s_32it on DIA(A + I/2)."""
    import numpy as np
    import scipy.sparse as sps
    import torch

    from libhpc_tpu_torch.bench import matrices
    from libhpc_tpu_torch.ops import solver, spmv
    from libhpc_tpu_torch.sparse import DIA
    from libhpc_tpu_torch.sparse.auto import auto_format

    A = matrices.poisson2d(1024)
    dia, matvec = auto_format(A)
    if not isinstance(dia, DIA) or matvec is not spmv.dia_spmv:
        raise AssertionError(f"poisson1024 routed to {type(dia).__name__}")
    diad = dia.to(dev)
    x = np.linspace(-1.0, 1.0, A.shape[1], dtype=np.float32)
    xd = torch.from_numpy(x).to(dev)
    gate(matvec(diad, xd), A @ x, "poisson1024 dia_spmv")
    times = spmv_times(lambda: matvec(diad, xd))

    As = (A + sps.eye(A.shape[0]) * 0.5).tocsr()
    dsh = DIA.from_scipy(As, device=dev)
    b = torch.ones(A.shape[0], device=dev)
    n_it = 32
    out = {}

    def run():
        out["r"] = solver.cg(lambda u: spmv.dia_spmv(dsh, u), b, tol=0.0,
                             max_iter=n_it)

    ms = wall_ms(run)
    xs, it, _ = out["r"]
    r = np.ones(A.shape[0]) - As @ xs.cpu().numpy().astype(np.float64)
    if not (np.isfinite(r).all()
            and np.linalg.norm(r) < 1e-3 * np.sqrt(A.shape[0])):
        raise AssertionError(f"cg_dia_poisson1024s_32it residual "
                             f"{np.linalg.norm(r)}")
    emit({"phase": "dia_xla", "matrix": "poisson2d(1024)", "rows":
          A.shape[0], "nnz": int(A.nnz), "container": "DIA", **times,
          "gnnz_per_s": A.nnz / (times["spmv_device_ms"] * 1e-3) / 1e9
          if times["spmv_device_ms"] else None})
    emit({"phase": "dia_xla", "system": "cg_dia_poisson1024s_32it",
          "iterations": it, "ms": ms, "ms_per_iteration": ms / it,
          "residual": float(np.linalg.norm(r)),
          "gnnz_per_s": it * As.nnz / (ms * 1e-3) / 1e9})


def irregular_band(n: int, seed: int = 0):
    """4 random nnz per row within +-120 of the diagonal
    (tests/test_auto_format.py:43-49 at size n)."""
    import numpy as np
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 4)
    cols = np.clip(rows + rng.integers(-120, 121, rows.size), 0, n - 1)
    A = sps.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def sell_case(name, A, sp, dev, kernel_times, launches):
    """One SELL / SELLSplit operand: sell_spmv (the path) against scipy,
    then K6 on each part against its plain version, with times."""
    import numpy as np
    import torch

    from libhpc_tpu_torch.ops import spmv_sell

    spd = sp.to(dev)
    parts = ({"near": spd.near, "wide": spd.wide}
             if isinstance(spd, spmv_sell.SELLSplit) else {"all": spd})
    x = np.linspace(-1.0, 1.0, A.shape[1], dtype=np.float32)
    xd = torch.from_numpy(x).to(dev)
    spmv_sell.SELL_LAUNCHES = 0
    y = spmv_sell.sell_spmv(spd, xd)
    torch.cuda.synchronize()
    launches[f"sell_{name}"] = {"sell": spmv_sell.SELL_LAUNCHES,
                                "matvecs": 1, "per_matvec": len(parts)}
    gate(y, A @ x, f"{name} sell_spmv")
    x3 = spmv_sell.x_panes(xd, spd.n_panes, spd.W - 1)
    rec = {}
    for part, s in parts.items():
        out_bytes = (s.n_stripes + s.W - 1) * 1024 * 4
        WORK[("sell", f"{name}/{part}")] = (
            leaf_bytes(s) + nbytes(x3) + out_bytes, 2 * s.vflat.numel())
        rec[part] = hold("sell", f"{name}/{part}",
                         lambda s=s: spmv_sell.sell_out_panes(s, x3),
                         lambda s=s: spmv_sell.sell_out_panes_torch(s, x3),
                         kernel_times)
    emit({"phase": "sell", "matrix": name, "rows": A.shape[0],
          "nnz": int(A.nnz), "container": type(sp).__name__, "W": sp.W,
          "n_tiles": sp.n_tiles, "hbm_bytes": sp.hbm_bytes,
          "max_abs_err_vs_scipy": float(np.abs(y.cpu().numpy()
                                               - A @ x).max()),
          **{f"{p}_kernel_device_ms": r[0] for p, r in rec.items()},
          **{f"{p}_plain_device_ms": r[1] for p, r in rec.items()},
          **{f"{p}_max_abs_err_vs_plain": r[2] for p, r in rec.items()},
          **{f"{p}_kernel_cold_l2_device_ms": r[3] for p, r in rec.items()},
          "kernel_gb_per_s": sp.hbm_bytes / (sum(r[0] for r in rec.values())
                                             * 1e-3) / 1e9,
          **spmv_times(lambda: spmv_sell.sell_spmv(spd, xd))})


def sell_phase(A_p, dev, kernel_times, launches):
    from libhpc_tpu_torch.ops import spmv_sell
    from libhpc_tpu_torch.sparse import ELL
    from libhpc_tpu_torch.sparse.auto import auto_format
    from libhpc_tpu_torch.sparse.csr import CSR

    sp = spmv_sell.sell_from_ell(ELL.from_csr(CSR.from_scipy(A_p)))
    if not (isinstance(sp, spmv_sell.SELLSplit) and sp.n_tiles == 5120
            and 48e6 < sp.hbm_bytes < 52e6):
        raise AssertionError(f"Poisson 1024^2 SELL: {type(sp).__name__}, "
                             f"{sp.n_tiles} tiles, {sp.hbm_bytes} B")
    sell_case("poisson1024", A_p, sp, dev, kernel_times, launches)

    A = irregular_band(2 ** 20)
    t0 = time.perf_counter()
    c, matvec = auto_format(A)
    build_s = time.perf_counter() - t0
    if not (isinstance(c, spmv_sell.SELL) and matvec is spmv_sell.sell_spmv
            and c.W == 3 and c.n_tiles == 4096
            and 40e6 < c.hbm_bytes < 44e6):
        raise AssertionError(f"irregular band: {type(c).__name__}")
    emit({"phase": "sell", "matrix": "irregular_band(2^20)",
          "auto_format_s": build_s})
    sell_case("band2^20", A, c, dev, kernel_times, launches)


def sellp_phase(A, dev, kernel_times, launches):
    import numpy as np
    import torch

    from libhpc_tpu_torch.ops import sellp, spmv_sell

    sp = sellp.sellp_from_scipy(A)
    if sp.n_tiles != 5120 or not sp.fill_ratio(A.nnz) < 1.001:
        raise AssertionError(f"Poisson 1024^2 SELL-P: {sp.n_tiles} tiles")
    spd = sp.to(dev)
    x = np.linspace(-1.0, 1.0, A.shape[1], dtype=np.float32)
    xd = torch.from_numpy(x).to(dev)
    sellp.SELLP_LAUNCHES = 0
    y = sellp.sellp_spmv(spd, xd)
    torch.cuda.synchronize()
    launches["sellp"] = {"sellp": sellp.SELLP_LAUNCHES, "matvecs": 1}
    gate(y, A @ x, "poisson1024 sellp_spmv")
    x3 = spmv_sell.x_panes(xd, spd.n_panes)
    WORK[("sellp", "poisson1024")] = (
        leaf_bytes(spd) + nbytes(x3) + spd.n_stripes * 1024 * 4,
        2 * spd.vflat.numel())
    t_k, t_p, err, c_k = hold("sellp", "poisson1024",
                         lambda: sellp.sellp_out_panes(spd, x3),
                         lambda: sellp.sellp_out_panes_torch(spd, x3),
                         kernel_times)
    emit({"phase": "sellp", "matrix": "poisson2d(1024)", "rows": A.shape[0],
          "nnz": int(A.nnz), "n_tiles": sp.n_tiles,
          "fill_ratio": sp.fill_ratio(A.nnz), "hbm_bytes": sp.hbm_bytes,
          "max_abs_err_vs_scipy": float(np.abs(y.cpu().numpy()
                                               - A @ x).max()),
          "kernel_device_ms": t_k, "plain_device_ms": t_p,
          "kernel_cold_l2_device_ms": c_k, "max_abs_err_vs_plain": err,
          "kernel_gb_per_s": sp.hbm_bytes / (t_k * 1e-3) / 1e9,
          **spmv_times(lambda: sellp.sellp_spmv(spd, xd))})


SORT_SEED = 20260501
FLIP = -(2 ** 31)        # u32 order of int32 bit patterns: x ^ FLIP
LIBHPC_SORT_MS = 360.0   # BASELINE.md:11-12: 500M u32, RTX 3080 Ti laptop


def sort_keys(n: int, dev, seed: int = SORT_SEED):
    """n random u32 keys on the card (int32 bit patterns), from a seed."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                         generator=g)


def sorted_bits(bits):
    """torch.sort's u32 order of int32 bit patterns (the plain whole)."""
    import torch

    return torch.sort(bits ^ FLIP).values ^ FLIP


def expected_sort_launches(n: int, log2c: int, sm=None) -> dict:
    """Launches of the chunk kernel, of the merge kernel, of its pair
    merges and of the split kernel that module sm's sort (sort_merge: K8,
    K9/K10; sort_merge_kv: K11, K12) makes for n keys: per segment of 2^p
    one chunk sort, the merge levels inside a chunk larger than the chunk
    kernel takes, p - log2c levels; one pair merge per extra segment; one
    split search a merge."""
    if sm is None:
        from libhpc_tpu_torch.ops import sort_merge as sm

    segs = sm._decompose(n, 1 << log2c)
    sub = min(log2c, sm.LOG2C_KERNEL)
    levels = sum(log2c - sub + s.bit_length() - 1 - log2c for s in segs)
    merges = levels + len(segs) - 1
    return {"chunk": len(segs), "merge": merges, "pair": len(segs) - 1,
            "split": merges}


CHUNK_KERNEL = "chunk_sort_kernel"      # K8, K11 (csrc/sort_chunk.cu)


def sort_path(n: int, dev, segs_want, launches, name: str):
    """merge_sort_u32 on n seeded u32 keys (the path, counters zeroed just
    before and read just after), held exactly against torch.sort; then its
    device and wall times beside torch.sort's."""
    import torch

    from libhpc_tpu_torch.ops import sort_merge as sm

    segs = sm._decompose(n, 1 << sm.DEFAULT_LOG2C)
    if segs != segs_want:
        raise AssertionError(f"{name}: {n} decomposes into {segs}")
    keys = sort_keys(n, dev)
    ku = keys.view(torch.uint32)
    torch.cuda.synchronize()
    sm.CHUNK_LAUNCHES = sm.MERGE_LAUNCHES = sm.PAIR_LAUNCHES = 0
    sm.SPLIT_LAUNCHES = 0
    out = sm.merge_sort_u32(ku)
    torch.cuda.synchronize()
    launches[name] = {"chunk": sm.CHUNK_LAUNCHES,
                      "merge": sm.MERGE_LAUNCHES, "pair": sm.PAIR_LAUNCHES,
                      "split": sm.SPLIT_LAUNCHES,
                      "need": expected_sort_launches(n, sm.DEFAULT_LOG2C)}
    if out.dtype != torch.uint32 or out.shape != (n,):
        raise AssertionError(f"{name}: {out.dtype} {tuple(out.shape)}")
    want = sorted_bits(keys)
    if not torch.equal(out.view(torch.int32), want):
        bad = int((out.view(torch.int32) != want).sum())
        raise AssertionError(f"{name}: {bad} of {n} keys differ from "
                             "torch.sort")
    del out, want
    flipped = keys ^ FLIP
    fns = {"sort": lambda: sm.merge_sort_u32(ku),
           "torch_sort": lambda: torch.sort(flipped)}
    rec = {"sort_device_ms": graph_ms(fns["sort"], reps=3),
           # torch.sort is a few long kernels: events time the device
           "torch_sort_device_ms": time_ms(fns["torch_sort"], reps=5)}
    for k, f in fns.items():
        rec[f"{k}_wall_ms"] = wall_ms(f, reps=3)
    torch.cuda.synchronize()
    emit({"phase": name, "n": n, "segments": segs,
          "log2c": sm.DEFAULT_LOG2C, "log2w": sm.DEFAULT_LOG2W,
          "kernel_window": 1 << sm.LOG2W_KERNEL,
          "kernel_sub_chunk": 1 << sm.LOG2C_KERNEL,
          "equal_to_torch_sort": True, **launches[name], **rec,
          "g_keys_per_s_device": n / (rec["sort_device_ms"] * 1e-3) / 1e9,
          "g_keys_per_s_wall": n / (rec["sort_wall_ms"] * 1e-3) / 1e9,
          "fraction_torch_sort_over_sort_device":
              rec["torch_sort_device_ms"] / rec["sort_device_ms"],
          "libhpc_500m_ms_rtx3080ti_laptop": LIBHPC_SORT_MS})
    return keys


def hold_exact(kind, case, kernel, plain, region, kernel_times,
               timer=graph_ms):
    """A kernel against its plain version on the same inputs, exactly over
    `region` (the data region of a work buffer), then the device time of
    each by `timer`. Records (ms, plain_ms, max_abs_err)."""
    import torch

    got, want = region(kernel()), region(plain())
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{case}: {kind} kernel differs from its plain "
                             f"version in {int((got != want).sum())} places")
    err = float((got.long() - want.long()).abs().max())
    del got, want
    kernel_times[kind][case] = (timer(kernel), timer(plain), err)
    return kernel_times[kind][case]


MERGE_KERNEL = "merge_path_kernel"      # K9, K10, K12 (csrc/sort_merge.cu)
SPLIT_KERNEL = "split_search_kernel"    # the split search, one a merge


def cupti_kernels(call, names, reps: int = 3) -> dict:
    """Device ms per call (CUPTI) of the kernels whose names hold each of
    `names`, each launched once a call; None where the profile was
    lossy."""
    total, split = device_ms(call, reps=reps, want={n: 1 for n in names})
    if not total:
        return {n: None for n in names}
    return {n: sum(v for k, v in split.items() if n in k) for n in names}


def hold_merge(kind, case, call, plain, region, kernel_times, plan,
               plan_plain, merge):
    """A merge (K9, K10 or K12) against its plain version, exactly, and
    its split plan against the split kernel's plain version, exactly.
    `call` is the whole merge (split search, then merge), `merge(p)` the
    merge kernel alone on a plan p. Times: the merge kernel alone and the
    split kernel alone, each one launch replayed as a CUDA graph (their
    kinds' times), and by CUPTI inside the whole call where the profile
    is whole; the whole call by graph replay. Returns them in ms."""
    import torch

    whole, plain_ms, err = hold_exact(kind, case, call, plain, region,
                                      kernel_times)
    p, want = plan(), plan_plain()
    if p.shape != want.shape or not torch.equal(p, want):
        raise AssertionError(f"{case}: split kernel differs from its plain "
                             f"version in {int((p != want).sum())} places")
    del want
    alone = graph_ms(lambda: merge(p))
    split_alone = graph_ms(plan)
    split_plain = graph_ms(plan_plain)
    t = cupti_kernels(call, (MERGE_KERNEL, SPLIT_KERNEL))
    kernel_times[kind][case] = (alone, plain_ms, err)
    kernel_times["sort_split_search"][f"{kind}/{case}"] = (
        split_alone, split_plain, 0.0)
    return {"kernel": alone, "split": split_alone, "call": whole,
            "plain": plain_ms, "split_plain": split_plain,
            "kernel_cupti": t[MERGE_KERNEL], "split_cupti": t[SPLIT_KERNEL]}


def merge_window_sweep(x, log2p: int, windows=(11, 12, 13)) -> dict:
    """The merge kernel alone (one launch on a ready plan, replayed as a
    CUDA graph) and the split kernel at each window 2^lw of `windows`, on
    one level of a 2^log2p sort (runs of 2^16), keys alone and with
    payloads, each exactly against its plain version: the data behind
    sort_merge.LOG2W_KERNEL."""
    import torch

    from libhpc_tpu_torch.ops import sort_merge as sm
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    P = 1 << log2p
    PAD = 1 << sm.DEFAULT_LOG2W
    rows = (2 * PAD + P + 16 * 128) // 128
    log2r = sm.DEFAULT_LOG2C
    runs = sm._chunk_sort_torch(x, PAD // 128, rows, log2c=log2r,
                                alternate=True, invert=False, unflip=False)
    v = torch.arange(P, dtype=torch.int32, device=x.device)
    bk, bv = kv._chunk_sort_kv_torch(x, v, PAD // 128, rows, log2c=log2r,
                                     alternate=True, invert=False,
                                     unflip=False)
    out, keep = {}, sm.LOG2W_KERNEL
    try:
        for lw in windows:
            sm.LOG2W_KERNEL = lw

            def keys_only(lw=lw):
                return sm._merge_level(runs, P, PAD, rows, log2r, lw, False,
                                       False)

            def with_payloads(lw=lw):
                return kv._merge_level_kv(bk, bv, P, PAD, rows, log2r, lw,
                                          False, False)

            want = sm._merge_level_torch(runs, P, PAD, rows, log2r, lw,
                                         False, False)
            wk, _ = kv._merge_level_kv_torch(bk, bv, P, PAD, rows, log2r, lw,
                                             False, False)
            gk, gv = with_payloads()
            region = slice(PAD, PAD + P)
            if not (torch.equal(keys_only().reshape(-1)[region],
                                want.reshape(-1)[region])
                    and torch.equal(gk.reshape(-1)[region],
                                    wk.reshape(-1)[region])
                    and torch.equal(torch.sort(gv.reshape(-1)[region]).values,
                                    v)):
                raise AssertionError(f"merge window 2^{lw}: the kernel "
                                     "differs from its plain version")
            del want, wk, gk, gv
            p = sm._level_plan(runs, P, PAD, log2r, lw, False)
            pk = sm._level_plan(bk, P, PAD, log2r, lw, False)
            out[f"2^{lw}"] = {
                "keys_ms": graph_ms(lambda: sm._merge_launch(
                    runs, runs, p, PAD, rows, lw, False, pair=False)),
                "kv_ms": graph_ms(lambda: kv._merge_launch_kv(
                    bk, bv, bk, bv, pk, PAD, rows, lw, False, pair=False)),
                "split_ms": graph_ms(lambda: sm._level_plan(
                    runs, P, PAD, log2r, lw, False))}
    finally:
        sm.LOG2W_KERNEL = keep
    return out


# (sub-chunk sizes, digit widths) of the chunk sort sweep
CHUNK_SWEEP = ((13, 14), (4, 5, 6))


def chunk_sort_sweep(x, v, log2p: int) -> dict:
    """K8 (v None) or K11 (payloads v) alone, one launch replayed as a CUDA
    graph, on 2^log2p keys at each sub-chunk size and digit width of
    CHUNK_SWEEP, each exactly against its plain version; and at each
    sub-chunk size, with the module's digit width, the whole chunk sort of
    the default chunk (K8 and K9 levels up to 2^16; K11 and K12 levels up
    to 2^15), exactly (kv: on distinct keys, the merges being unstable):
    the data behind the modules' LOG2C_KERNEL and RADIX_BITS."""
    import torch

    from libhpc_tpu_torch.ops import sort_merge as sm
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    mod = sm if v is None else kv
    PAD = 1 << mod.DEFAULT_LOG2W
    rows = (2 * PAD + (1 << log2p) + 16 * 128) // 128
    at = dict(pad_rows=PAD // 128, total_rows=rows, alternate=True,
              invert=False, unflip=False)
    region = slice(PAD, PAD + (1 << log2p))
    if v is None:
        def kernel(log2c):
            return (sm.chunk_sort_kernel(x, log2c=log2c, **at),)

        def plain(log2c):
            return (sm._chunk_sort_torch(x, log2c=log2c, **at),)

        def staged():
            return (sm._chunk_sort(x, log2c=sm.DEFAULT_LOG2C, **at),)
    else:
        def kernel(log2c):
            return kv.chunk_sort_kv_kernel(x, v, log2c=log2c, **at)

        def plain(log2c):
            return kv._chunk_sort_kv_torch(x, v, log2c=log2c, **at)

        def staged():
            return kv._chunk_sort_kv(x, v, log2c=kv.DEFAULT_LOG2C, **at)

    def data(bufs):
        return torch.cat([b.reshape(-1)[region] for b in bufs])

    sizes, widths = CHUNK_SWEEP
    keep = (mod.LOG2C_KERNEL, sm.RADIX_BITS)
    rec = {}
    try:
        staged_want = data(plain(mod.DEFAULT_LOG2C))
        for log2c in sizes:
            mod.LOG2C_KERNEL = log2c
            want = data(plain(log2c))
            for bits in widths:
                sm.RADIX_BITS = bits
                if not torch.equal(data(kernel(log2c)), want):
                    raise AssertionError(
                        f"chunk sort 2^{log2c}, {bits}-bit digits (kv: "
                        f"{v is not None}): the kernel differs from its "
                        "plain version")
                rec[f"2^{log2c}/b{bits}_ms"] = graph_ms(lambda: kernel(log2c))
            sm.RADIX_BITS = keep[1]
            if not torch.equal(data(staged()), staged_want):
                raise AssertionError(f"the chunk sort with 2^{log2c} "
                                     "sub-chunks differs from its plain "
                                     f"version (kv: {v is not None})")
            rec[f"staged_2^{mod.DEFAULT_LOG2C}/sub2^{log2c}_ms"] = graph_ms(
                staged)
        del want, staged_want
    finally:
        mod.LOG2C_KERNEL, sm.RADIX_BITS = keep
    return rec


def sort_kernels_phase(keys, kernel_times, log2p: int = 26):
    """K8, K9 and K10 each against its plain version on the buffers of a
    2^log2p-key sort (default log2c/log2w), invert and unflip cases
    included; the pair merge folds in a 2^(log2p-2) segment; K8 alone by
    graph replay; K8's chunk_sort_sweep."""
    import torch

    from libhpc_tpu_torch.ops import sort_merge as sm

    P = 1 << log2p
    x = keys[:P].contiguous()
    PAD = 1 << sm.DEFAULT_LOG2W
    rows = (2 * PAD + P + 16 * 128) // 128

    def data(buf, n=P):
        return buf.reshape(-1)[PAD:PAD + n]

    rec = {}
    for case, kw in {"asc": dict(alternate=True, invert=False, unflip=False),
                     "invert_unflip": dict(alternate=True, invert=True,
                                           unflip=True)}.items():
        for log2c, kind in ((sm.LOG2C_KERNEL, "sort_chunk"),
                            (sm.DEFAULT_LOG2C, "sort_chunk_staged")):
            t = hold_exact(
                kind, f"2^{log2p}/{case}",
                lambda: sm._chunk_sort(x, PAD // 128, rows, log2c=log2c,
                                       **kw),
                lambda: sm._chunk_sort_torch(x, PAD // 128, rows,
                                             log2c=log2c, **kw),
                data, kernel_times)
            rec[f"{kind}_2^{log2c}_{case}"] = t

    merges = {}
    for log2r, inv, unf in ((sm.DEFAULT_LOG2C, False, False),
                            (log2p - 1, True, True)):
        runs = sm._chunk_sort_torch(x, PAD // 128, rows, log2c=log2r,
                                    alternate=True, invert=False,
                                    unflip=False)
        lw = min(sm.DEFAULT_LOG2W, log2r)
        kw = min(lw, sm.LOG2W_KERNEL)
        case = f"2^{log2p}/r2^{log2r}"
        merges[f"sort_merge_level_r2^{log2r}"] = hold_merge(
            "sort_merge_level", case,
            lambda: sm._merge_level(runs, P, PAD, rows, log2r, lw, inv, unf),
            lambda: sm._merge_level_torch(runs, P, PAD, rows, log2r, lw,
                                          inv, unf),
            data, kernel_times,
            lambda: sm._level_plan(runs, P, PAD, log2r, kw, inv),
            lambda: sm._level_plan_torch(runs, P, PAD, log2r, kw, inv),
            lambda p: sm._merge_launch(runs, runs, p, PAD, rows, kw, unf,
                                       pair=False))
        rec[f"sort_merge_level_r2^{log2r}"] = (
            kernel_times["sort_merge_level"][case])
        # the split search's bytes: its eight int32 rows a window, and the
        # two keys each of its log2r + 1 steps compares, read once
        WORK[("sort_split_search", f"sort_merge_level/{case}")] = (
            4 * (P >> kw) * (8 + 2 * (log2r + 1)), 0)
        del runs

    LB = P >> 2
    flipped = keys[:P + LB] ^ FLIP
    for kind, case, rows_of in (
            ("sort_chunk", f"2^{log2p}/asc", 1 << sm.LOG2C_KERNEL),
            ("sort_merge_level", f"2^{log2p}/r2^{sm.DEFAULT_LOG2C}",
             2 << sm.DEFAULT_LOG2C)):
        WORK[(kind, case)] = (8 * P, 0)
        LIBRARY_MS[kind] = time_ms(
            lambda r=rows_of: torch.sort(flipped[:P].view(-1, r), dim=1),
            reps=5)
    WORK[("sort_merge_pair", f"2^{log2p}+2^{log2p - 2}/desc1")] = (
        8 * (P + LB), 0)
    LIBRARY_MS["sort_merge_pair"] = time_ms(lambda: torch.sort(flipped),
                                            reps=5)
    del flipped
    bufA, _ = sm._sort_segment(x, sm.DEFAULT_LOG2C, sm.DEFAULT_LOG2W,
                               invert=False, unflip=False)
    bufB, _ = sm._sort_segment(keys[P:P + LB].contiguous(),
                               sm.DEFAULT_LOG2C, sm.DEFAULT_LOG2W,
                               invert=True, unflip=False)
    lw = min(sm.DEFAULT_LOG2W, log2p - 2)   # merge_sort_u32's window rule
    kw = min(lw, sm.LOG2W_KERNEL)
    for desc_out, unf in ((True, False), (False, True)):
        case = f"2^{log2p}+2^{log2p - 2}/desc{int(desc_out)}"
        merges[f"sort_merge_pair_desc{int(desc_out)}"] = hold_merge(
            "sort_merge_pair", case,
            lambda: sm._merge_pair(bufA, bufB, P, LB, PAD, lw, desc_out,
                                   unf),
            lambda: sm._merge_pair_torch(bufA, bufB, P, LB, PAD, lw,
                                         desc_out, unf),
            lambda b: data(b, P + LB), kernel_times,
            lambda: sm._pair_plan(bufA, bufB, P, LB, PAD, kw, desc_out),
            lambda: sm._pair_plan_torch(bufA, bufB, P, LB, PAD, kw,
                                        desc_out),
            lambda p: sm._merge_launch(bufA, bufB, p, PAD,
                                       sm._pair_rows(P, LB, PAD), kw, unf,
                                       pair=True))
        rec[f"sort_merge_pair_desc{int(desc_out)}"] = (
            kernel_times["sort_merge_pair"][case])
    del bufA, bufB
    torch.cuda.synchronize()
    sweep = merge_window_sweep(x, log2p)
    chunk_sweep = chunk_sort_sweep(x, None, log2p)
    emit({"phase": "sort_kernels", "P": P,
          "kernel_window": 1 << sm.LOG2W_KERNEL,
          "kernel_sub_chunk": 1 << sm.LOG2C_KERNEL,
          "radix_bits": sm.RADIX_BITS,
          "merge_window_sweep": sweep, "chunk_sort_sweep": chunk_sweep,
          **{f"{k}_ms": v[0] for k, v in rec.items()},
          **{f"{k}_plain_ms": v[1] for k, v in rec.items()},
          **{f"{k}_{part}_ms": t[part] for k, t in merges.items()
             for part in ("kernel", "split", "call", "split_plain",
                          "kernel_cupti", "split_cupti")},
          "split_equal_to_plain": True,
          "max_abs_err": max(v[2] for v in rec.values())})


def radix_phase(dev):
    """radix_sort_pipeline and bitonic_sort (plain torch; no kernel of
    their own) at 2^22 keys, exactly against torch.sort, with times."""
    import torch

    from libhpc_tpu_torch.ops import sort

    n = 1 << 22
    keys = sort_keys(n, dev, seed=SORT_SEED + 1)
    want = sorted_bits(keys)
    rec = {}
    for name in ("radix_sort_pipeline", "bitonic_sort", "sort_u32"):
        fn = getattr(sort, name)
        got = fn(keys.view(torch.uint32))
        if not torch.equal(got.view(torch.int32), want):
            raise AssertionError(f"{name}: differs from torch.sort")
        rec[f"{name}_wall_ms"] = wall_ms(lambda: fn(keys.view(torch.uint32)))
    s, order = sort.argsort_u32(keys)
    if not (torch.equal(s.view(torch.int32), want)
            and torch.equal(keys[order.long()], want)):
        raise AssertionError("argsort_u32: differs from torch.sort")
    emit({"phase": "radix", "n": n, "equal_to_torch_sort": True, **rec})


def histogram_phase(keys, kernel_times, launches):
    """K15 on the four 8-bit digit planes of the sort's keys: the path
    (histogram_pallas per plane, counter zeroed before and read after),
    then each plane exactly against histogram_pallas_torch and the column
    sums of tile_histograms, with times."""
    import torch

    from libhpc_tpu_torch.ops import histogram, sort

    planes = [sort.digit_of(keys, shift) for shift in (0, 8, 16, 24)]
    torch.cuda.synchronize()
    histogram.HIST_LAUNCHES = 0
    hists = [histogram.histogram_pallas(d, 256) for d in planes]
    torch.cuda.synchronize()
    launches["histogram"] = {"hist": histogram.HIST_LAUNCHES,
                             "need": {"hist": len(planes)}}
    n = keys.shape[0]
    for i, (d, h) in enumerate(zip(planes, hists)):
        cols = sort.tile_histograms(d).sum(dim=0, dtype=torch.int32)
        if int(h.sum()) != n or not torch.equal(h, cols):
            raise AssertionError(f"plane {i}: K15 differs from the column "
                                 "sums of tile_histograms")
        del cols
        # one kernel per call, and a plain version that waits on the host
        # (bincount): CUDA events time both
        hold_exact("histogram", f"plane{i}",
                   lambda d=d: histogram.histogram_pallas(d, 256),
                   lambda d=d: histogram.histogram_pallas_torch(d, 256),
                   lambda h: h, kernel_times, timer=time_ms)
    t = kernel_times["histogram"]
    WORK[("histogram", "plane0")] = (nbytes(planes[0], hists[0]), 0)
    LIBRARY_MS["histogram"] = time_ms(
        lambda: torch.bincount(planes[0], minlength=256), reps=5)
    emit({"phase": "histogram", "n": n, "planes": len(planes),
          "launches": launches["histogram"]["hist"],
          **{f"{c}_ms": v[0] for c, v in t.items()},
          **{f"{c}_plain_ms": v[1] for c, v in t.items()},
          "max_abs_err": max(v[2] for v in t.values()),
          "gb_per_s_plane0": n * 4 / (t["plane0"][0] * 1e-3) / 1e9})


def u32_pairs(keys, vals):
    """(key, payload) pairs packed into int64 (key high) and sorted: equal
    for two results of an unstable sort that kept every payload beside its
    key."""
    import torch

    k = keys.view(torch.int32).long() & 0xFFFFFFFF
    v = vals.view(torch.int32).long() & 0xFFFFFFFF
    return torch.sort((k << 32) | v).values


def kv_path(name, n, keys, fn, launches, segs_want):
    """One kv sort of n keys through `fn` (the path: counters zeroed just
    before and read just after), the launches it must make, and its device
    time (CUDA-graph replay) and wall time beside torch.sort's with its
    indices, the library call computing the same output."""
    import torch

    from libhpc_tpu_torch.ops import sort_merge as sm
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    segs = kv._decompose(n, 1 << kv.DEFAULT_LOG2C)
    if segs != segs_want:
        raise AssertionError(f"{name}: {n} decomposes into {segs}")
    torch.cuda.synchronize()
    kv.CHUNK_LAUNCHES = kv.MERGE_LAUNCHES = kv.PAIR_LAUNCHES = 0
    sm.SPLIT_LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    launches[name] = {"chunk": kv.CHUNK_LAUNCHES, "merge": kv.MERGE_LAUNCHES,
                      "pair": kv.PAIR_LAUNCHES, "split": sm.SPLIT_LAUNCHES,
                      "need": expected_sort_launches(n, kv.DEFAULT_LOG2C, kv)}
    want = sorted_bits(keys)
    if out[0].dtype != torch.uint32 or not torch.equal(
            out[0].view(torch.int32), want):
        raise AssertionError(f"{name}: keys differ from torch.sort")
    del want
    flipped = keys ^ FLIP
    rec = {"device_ms": graph_ms(fn, reps=3),
           "torch_sort_device_ms": time_ms(lambda: torch.sort(flipped),
                                           reps=5),
           "wall_ms": wall_ms(fn, reps=3),
           "torch_sort_wall_ms": wall_ms(lambda: torch.sort(flipped),
                                         reps=3)}
    del flipped
    return out, rec, segs


def argsort_phase(keys, launches):
    """merge_argsort_u32 on the sort phase's 500M keys (one 2^29 segment,
    default log2c/log2w): keys exactly torch.sort's, order a permutation
    with keys[order] the sorted keys; device and wall time."""
    import torch

    from libhpc_tpu_torch.ops import sort_merge as sm
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    n = keys.shape[0]
    ku = keys.view(torch.uint32)
    (s, order), rec, segs = kv_path(
        "argsort", n, keys, lambda: kv.merge_argsort_u32(ku), launches,
        [1 << 29])
    if order.dtype != torch.int32 or order.shape != (n,):
        raise AssertionError(f"argsort: order {order.dtype} {order.shape}")
    if not torch.equal(keys[order.long()], s.view(torch.int32)):
        raise AssertionError("argsort: keys[order] differs from the keys")
    if not torch.equal(torch.sort(order).values,
                       torch.arange(n, dtype=torch.int32, device=keys.device)):
        raise AssertionError("argsort: order is not a permutation")
    del s, order
    torch.cuda.synchronize()
    emit({"phase": "argsort", "n": n, "segments": segs,
          "log2c": kv.DEFAULT_LOG2C, "log2w": kv.DEFAULT_LOG2W,
          "kernel_sub_chunk": 1 << kv.LOG2C_KERNEL,
          "kernel_window": 1 << sm.LOG2W_KERNEL,
          "equal_to_torch_sort": True, "order_is_permutation": True,
          **launches["argsort"], **rec,
          "g_keys_per_s_device": n / (rec["device_ms"] * 1e-3) / 1e9,
          "fraction_torch_sort_over_argsort_device":
              rec["torch_sort_device_ms"] / rec["device_ms"]})
    return rec


def sort_kv_segmented_phase(dev, launches):
    """merge_sort_kv_u32 on 100M keys of a seeded 16-value alphabet
    (0, 0x7FFFFFFF, 0x80000000 and 0xFFFFFFFF among them) with float32
    payloads: [2^26, 2^24, 2^24] segments, so K12 runs pair merges; the
    (key, payload) pairs equal the input's."""
    import torch

    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    n = 100_000_000
    g = torch.Generator(device=dev)
    g.manual_seed(SORT_SEED + 2)
    alphabet = torch.cat([
        torch.tensor([0, 0x7FFFFFFF, -2**31, -1], dtype=torch.int32,
                     device=dev),
        torch.randint(-2**31, 2**31, (12,), dtype=torch.int32, device=dev,
                      generator=g)])
    keys = alphabet[torch.randint(0, 16, (n,), device=dev, generator=g)]
    vals = torch.rand(n, device=dev, generator=g)
    ku = keys.view(torch.uint32)
    (ks, vs), rec, segs = kv_path(
        "sort_kv_segmented", n, keys,
        lambda: kv.merge_sort_kv_u32(ku, vals), launches,
        [1 << 26, 1 << 24, 1 << 24])
    if vs.dtype != torch.float32 or not torch.equal(u32_pairs(ks, vs),
                                                    u32_pairs(keys, vals)):
        raise AssertionError("sort_kv_segmented: (key, payload) pairs "
                             "differ from the input's")
    del ks, vs
    emit({"phase": "sort_kv_segmented", "n": n, "segments": segs,
          "alphabet": 16, "payload": "float32",
          "pairs_equal_to_input": True, **launches["sort_kv_segmented"],
          **rec})


def kv_kernels_phase(dev, kernel_times, log2p: int = 26):
    """K11 (2^LOG2C_KERNEL chunks and the staged 2^15 chunk), K12 as a
    level and as a pair, each exactly against its plain version (keys and
    payloads) on the buffers of a 2^log2p-key sort of distinct keys, invert
    and unflip cases included; device times by CUDA-graph replay; K11's
    chunk_sort_sweep."""
    import torch

    from libhpc_tpu_torch.ops import sort_merge as sm
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    P = 1 << log2p
    LB = P >> 2
    g = torch.Generator(device=dev)
    g.manual_seed(SORT_SEED + 3)
    perm = torch.randperm(P + LB, device=dev, generator=g)
    low = torch.randint(0, 32, (P + LB,), device=dev, generator=g)
    # distinct 32-bit patterns spread over the whole range
    keys = ((perm << 5) | low).to(torch.int32)
    vals = torch.randint(-2**31, 2**31, (P + LB,), dtype=torch.int32,
                         device=dev, generator=g)
    del perm, low
    x, v = keys[:P].contiguous(), vals[:P].contiguous()
    PAD = 1 << kv.DEFAULT_LOG2W
    rows = (2 * PAD + P + 16 * 128) // 128

    def data(bufs, n=P):
        return torch.cat([b.reshape(-1)[PAD:PAD + n] for b in bufs])

    rec, merges = {}, {}
    for case, kw in {"asc": dict(alternate=True, invert=False, unflip=False),
                     "invert_unflip": dict(alternate=True, invert=True,
                                           unflip=True)}.items():
        for log2c, kind in ((kv.LOG2C_KERNEL, "sort_chunk_kv"),
                            (kv.DEFAULT_LOG2C, "sort_chunk_kv_staged")):
            rec[f"{kind}_2^{log2c}_{case}"] = hold_exact(
                kind, f"2^{log2p}/{case}",
                lambda: kv._chunk_sort_kv(x, v, PAD // 128, rows,
                                          log2c=log2c, **kw),
                lambda: kv._chunk_sort_kv_torch(x, v, PAD // 128, rows,
                                                log2c=log2c, **kw),
                data, kernel_times)

    for log2r, inv, unf in ((kv.DEFAULT_LOG2C, False, False),
                            (log2p - 1, True, True)):
        bk, bv = kv._chunk_sort_kv_torch(x, v, PAD // 128, rows, log2c=log2r,
                                         alternate=True, invert=False,
                                         unflip=False)
        lw = min(kv.DEFAULT_LOG2W, log2r)
        kw = min(lw, sm.LOG2W_KERNEL)
        case = f"2^{log2p}/r2^{log2r}"
        merges[f"sort_merge_kv_level_r2^{log2r}"] = hold_merge(
            "sort_merge_kv_level", case,
            lambda: kv._merge_level_kv(bk, bv, P, PAD, rows, log2r, lw, inv,
                                       unf),
            lambda: kv._merge_level_kv_torch(bk, bv, P, PAD, rows, log2r, lw,
                                             inv, unf),
            data, kernel_times,
            lambda: sm._level_plan(bk, P, PAD, log2r, kw, inv),
            lambda: sm._level_plan_torch(bk, P, PAD, log2r, kw, inv),
            lambda p: kv._merge_launch_kv(bk, bv, bk, bv, p, PAD, rows, kw,
                                          unf, pair=False))
        rec[f"sort_merge_kv_level_r2^{log2r}"] = (
            kernel_times["sort_merge_kv_level"][case])
        del bk, bv

    ak, av = kv._sort_segment_kv(x, v, kv.DEFAULT_LOG2C, kv.DEFAULT_LOG2W,
                                 invert=False, unflip=False)
    bk, bv = kv._sort_segment_kv(keys[P:].contiguous(), vals[P:].contiguous(),
                                 kv.DEFAULT_LOG2C, kv.DEFAULT_LOG2W,
                                 invert=True, unflip=False)
    lw = min(kv.DEFAULT_LOG2W, log2p - 2)
    kw = min(lw, sm.LOG2W_KERNEL)
    for desc_out, unf in ((True, False), (False, True)):
        case = f"2^{log2p}+2^{log2p - 2}/desc{int(desc_out)}"
        merges[f"sort_merge_kv_pair_desc{int(desc_out)}"] = hold_merge(
            "sort_merge_kv_pair", case,
            lambda: kv._merge_pair_kv(ak, av, bk, bv, P, LB, PAD, lw,
                                      desc_out, unf),
            lambda: kv._merge_pair_kv_torch(ak, av, bk, bv, P, LB, PAD, lw,
                                            desc_out, unf),
            lambda b: data(b, P + LB), kernel_times,
            lambda: sm._pair_plan(ak, bk, P, LB, PAD, kw, desc_out),
            lambda: sm._pair_plan_torch(ak, bk, P, LB, PAD, kw, desc_out),
            lambda p: kv._merge_launch_kv(ak, av, bk, bv, p, PAD,
                                          sm._pair_rows(P, LB, PAD), kw, unf,
                                          pair=True))
        rec[f"sort_merge_kv_pair_desc{int(desc_out)}"] = (
            kernel_times["sort_merge_kv_pair"][case])
    del ak, av, bk, bv

    flipped = keys ^ FLIP
    for kind, case, row in (
            ("sort_chunk_kv", f"2^{log2p}/asc", 1 << kv.LOG2C_KERNEL),
            ("sort_merge_kv_level", f"2^{log2p}/r2^{kv.DEFAULT_LOG2C}",
             2 << kv.DEFAULT_LOG2C)):
        WORK[(kind, case)] = (16 * P, 0)
        LIBRARY_MS[kind] = time_ms(
            lambda r=row: torch.sort(flipped[:P].view(-1, r), dim=1), reps=5)
    WORK[("sort_merge_kv_pair", f"2^{log2p}+2^{log2p - 2}/desc1")] = (
        16 * (P + LB), 0)
    LIBRARY_MS["sort_merge_kv_pair"] = time_ms(lambda: torch.sort(flipped),
                                               reps=5)
    del flipped, keys, vals
    torch.cuda.synchronize()
    chunk_sweep = chunk_sort_sweep(x, v, log2p)
    del x, v
    emit({"phase": "kv_kernels", "P": P, "distinct_keys": True,
          "kernel_sub_chunk": 1 << kv.LOG2C_KERNEL,
          "radix_bits": sm.RADIX_BITS,
          "chunk_sort_sweep": chunk_sweep,
          **{f"{k}_ms": r[0] for k, r in rec.items()},
          **{f"{k}_plain_ms": r[1] for k, r in rec.items()},
          **{f"{k}_{part}_ms": t[part] for k, t in merges.items()
             for part in ("kernel", "split", "call", "split_plain",
                          "kernel_cupti", "split_cupti")},
          "split_equal_to_plain": True,
          "max_abs_err": max(r[2] for r in rec.values())})


def kernel_case(kind, case, kernel, plain, check, kernel_times, reps=20):
    """A kernel against its plain version on the same inputs (`check`
    raises and returns the max |diff|), then CUDA-event times of each over
    back-to-back calls (a few long kernels each). Records (ms, plain_ms,
    max_abs_err)."""
    got, want = kernel(), plain()
    err = check(got, want, f"{case}: {kind} kernel vs plain")
    del got, want
    kernel_times[kind][case] = (time_ms(kernel, reps=reps),
                                time_ms(plain, reps=max(3, reps // 2)), err)
    return kernel_times[kind][case]


def scan_case(kind, case, x, kernel, plain, library, check, kernel_times):
    """kernel_case for a scan, with its bytes and the library call's time."""
    t = kernel_case(kind, case, kernel, plain, check, kernel_times, reps=10)
    n = x.shape[0]
    WORK[(kind, case)] = (8 * n, n if x.is_floating_point() else 0)
    return t + (time_ms(library, reps=10),)


def scan_phase(keys, dev, kernel_times, launches):
    """K14 on 500M int32 flags (digit 0 of the sort's keys == 0), exactly
    against its plain version and int64 cumsum, bit for bit the same on a
    second run, and on a wraparound case; K13 on 500M seeded f32 in [0, 1)
    within TOL_SCAN of a float64 cumsum and of its plain version; both at
    EDGE_SIZES against the same oracles, and again at 2^22 (the reference
    corpus's size) with times beside torch.cumsum and the byte bound (one
    pass: 8 bytes an element)."""
    import torch

    from libhpc_tpu_torch.ops import scan

    n = keys.shape[0]
    flags = ((keys & 255) == 0).to(torch.int32)
    g = torch.Generator(device=dev)
    g.manual_seed(SORT_SEED + 4)
    xf = torch.rand(n, device=dev, generator=g)
    torch.cuda.synchronize()
    scan.SCAN_INT_LAUNCHES = scan.SCAN_F32_LAUNCHES = 0
    out_i = scan.exclusive_scan_pallas(flags)
    out_f = scan.exclusive_scan_pallas(xf)
    torch.cuda.synchronize()
    launches["scan"] = {"scan_int": scan.SCAN_INT_LAUNCHES,
                        "scan_f32": scan.SCAN_F32_LAUNCHES,
                        "need": {"scan_int": 1, "scan_f32": 1}}
    if not torch.equal(out_i.long(),
                       torch.cumsum(flags, 0, dtype=torch.int64) - flags):
        raise AssertionError("scan: K14 differs from int64 cumsum")
    # the look-back's order of adds varies from run to run: K14 must not
    # change, K13 may in its last bits
    if not torch.equal(scan.exclusive_scan_pallas(flags), out_i):
        raise AssertionError("scan: two runs of K14 differ")
    f32_repeat_equal = torch.equal(scan.exclusive_scan_pallas(xf), out_f)
    oracle = torch.cumsum(xf.double(), 0) - xf.double()
    err_f = max_err(out_f.double(), oracle)
    if not torch.allclose(out_f.double(), oracle, rtol=TOL_SCAN,
                          atol=TOL_SCAN):
        raise AssertionError(f"scan: K13 off the float64 oracle by {err_f}")
    del out_i, out_f, oracle
    # a tile and one element; many more tiles than resident blocks
    for size in EDGE_SIZES:
        fi, ff = flags[:size].clone(), xf[:size].clone()
        if not torch.equal(scan.exclusive_scan_pallas(fi).long(),
                           torch.cumsum(fi, 0, dtype=torch.int64) - fi):
            raise AssertionError(f"scan: K14 at n = {size} differs from "
                                 "int64 cumsum")
        want = torch.cumsum(ff.double(), 0) - ff.double()
        if not torch.allclose(scan.exclusive_scan_pallas(ff).double(), want,
                              rtol=TOL_SCAN, atol=TOL_SCAN):
            raise AssertionError(f"scan: K13 at n = {size} off float64")
    del fi, ff, want

    def close(got, want, what):
        if not torch.allclose(got, want, rtol=TOL_SCAN, atol=TOL_SCAN):
            raise AssertionError(f"{what}: max |diff| {max_err(got, want)}")
        return max_err(got, want)

    rec = {}
    wrap = torch.full((5_000_001,), 2**30, dtype=torch.int32, device=dev)
    w = scan.exclusive_scan_pallas(wrap)
    if (not torch.equal(w, scan._exclusive_scan_int_torch(wrap))
            or w[:5].tolist() != [0, 2**30, -2**31, -2**30, 0]):
        raise AssertionError("scan: K14 does not wrap as int32 adds do")
    for size, fi, ff in ((n, flags, xf), (1 << 22, flags[:1 << 22].clone(),
                                          xf[:1 << 22].clone())):
        tag = "500M" if size == n else "2^22"
        rec[f"int_{tag}"] = scan_case(
            "scan_int", tag, fi, lambda fi=fi: scan._exclusive_scan_int(fi),
            lambda fi=fi: scan._exclusive_scan_int_torch(fi),
            lambda fi=fi: torch.cumsum(fi, 0, dtype=torch.int32), exact_plain,
            kernel_times)
        rec[f"f32_{tag}"] = scan_case(
            "scan_f32", tag, ff, lambda ff=ff: scan._exclusive_scan_f32(ff),
            lambda ff=ff: scan._exclusive_scan_f32_torch(ff),
            lambda ff=ff: torch.cumsum(ff, 0), close, kernel_times)
    LIBRARY_MS["scan_int"] = rec["int_500M"][3]
    LIBRARY_MS["scan_f32"] = rec["f32_500M"][3]
    del flags, xf
    torch.cuda.synchronize()
    bound = {k: 8 * (n if k.endswith("500M") else 1 << 22) / PEAK_BYTES_S
             * 1e3 for k in rec}
    emit({"phase": "scan", "n": n, "k14_equal_to_int64_cumsum": True,
          "k14_two_runs_bit_equal": True,
          "k13_two_runs_bit_equal": f32_repeat_equal,
          "k13_max_abs_err_vs_float64": err_f, "wraparound_ok": True,
          "edge_sizes_ok": list(EDGE_SIZES), "bytes_per_elem": 8,
          **launches["scan"],
          **{f"{k}_ms": r[0] for k, r in rec.items()},
          **{f"{k}_plain_ms": r[1] for k, r in rec.items()},
          **{f"{k}_max_abs_err_vs_plain": r[2] for k, r in rec.items()},
          **{f"{k}_torch_cumsum_ms": r[3] for k, r in rec.items()},
          **{f"{k}_bound_ms": b for k, b in bound.items()},
          **{f"{k}_gb_per_s": 8 * (n if k.endswith("500M") else 1 << 22)
             / (r[0] * 1e-3) / 1e9 for k, r in rec.items()}})


DENSE_SEED = 20260502
DENSE_N = 8192           # the corpus's 8192^2 arrays (bench/corpus.py:62-133)


def rand_on(shape, dev, seed, dtype=None):
    """Seeded uniform [0, 1) float32 tensor on the card (cast to dtype)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.rand(shape, device=dev, generator=g)
    return x if dtype is None else x.to(dtype)


def close_plain(got, want, what):
    assert_close(got, want, what, TOL_PLAIN, TOL_PLAIN)
    return max_err(got, want)


def exact_plain(got, want, what):
    import torch

    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{what}: differs")
    return 0.0


def reduce_phase(dev, kernel_times, launches):
    """K16 on (8192, 8192) float32 (the path: counter zeroed before, read
    after) against its plain version and a float64 row sum; then
    tree_reduce_sum and the segment ops on 2^24 elements against torch
    oracles; times beside torch.sum."""
    import torch

    from libhpc_tpu_torch.ops import reduce as red

    x = rand_on((DENSE_N, DENSE_N), dev, DENSE_SEED)
    torch.cuda.synchronize()
    red.ROW_SUM_LAUNCHES = 0
    out = red.row_sum_pallas(x)
    torch.cuda.synchronize()
    launches["reduce"] = {"row_sum": red.ROW_SUM_LAUNCHES,
                          "need": {"row_sum": 1}}
    oracle = x.double().sum(dim=1)
    err64 = max_err(out.double(), oracle)
    if out.shape != (DENSE_N,) or not torch.allclose(
            out.double(), oracle, rtol=TOL_ROW, atol=0):
        raise AssertionError(f"row_sum_pallas: off float64 by {err64}")
    t_k, t_p, err = kernel_case(
        "row_sum", "8192^2", lambda: red.row_sum_pallas(x),
        lambda: red.row_sum_pallas_torch(x), close_plain, kernel_times)
    WORK[("row_sum", "8192^2")] = (nbytes(x, out), x.numel())
    LIBRARY_MS["row_sum"] = time_ms(lambda: torch.sum(x, dim=1))
    del out, oracle

    n = 1 << 24
    xf = x.reshape(-1)[:n]
    xi = (x.reshape(-1)[n:2 * n] * 100).to(torch.int32)   # sum < 2^31
    ids = (x.reshape(-1)[2 * n:3 * n] * 1024).to(torch.int64)
    tree_f = red.tree_reduce_sum(xf)
    tree_i = red.tree_reduce_sum(xi)
    sum64 = float(xf.double().sum())
    if (abs(float(tree_f) - sum64) > 1e-5 * sum64
            or int(tree_i) != int(xi.long().sum())
            or tree_i.dtype != torch.int32):
        raise AssertionError(f"tree_reduce_sum: {float(tree_f)} vs {sum64}, "
                             f"{int(tree_i)} vs {int(xi.long().sum())}")
    seg = {f: getattr(red, f)(xf, ids, 1024)
           for f in ("segment_sum", "segment_max", "segment_min")}
    # oracles: a float64 index_add, and the ends of each segment's run
    # after a stable sort by value, then by id
    want_sum = torch.zeros(1024, dtype=torch.float64, device=dev)
    want_sum.index_add_(0, ids, xf.double())
    order = torch.sort(xf, stable=True).indices
    order = order[torch.sort(ids[order], stable=True).indices]
    ends = torch.cumsum(torch.bincount(ids, minlength=1024), 0) - 1
    starts = torch.cat([ends.new_zeros(1), ends[:-1] + 1])
    if not (torch.allclose(seg["segment_sum"].double(), want_sum,
                           rtol=TOL_ROW)
            and torch.equal(seg["segment_max"], xf[order[ends]])
            and torch.equal(seg["segment_min"], xf[order[starts]])):
        raise AssertionError("segment ops differ from their oracles")
    rec = {"tree_reduce_sum_f32_ms": time_ms(lambda: red.tree_reduce_sum(xf)),
           **{f"{f}_ms": time_ms(lambda f=f: getattr(red, f)(xf, ids, 1024))
              for f in seg}}
    del x, xf, xi, ids, seg, order
    torch.cuda.synchronize()
    emit({"phase": "reduce", "shape": [DENSE_N, DENSE_N],
          **launches["reduce"], "row_sum_ms": t_k, "row_sum_plain_ms": t_p,
          "row_sum_max_abs_err_vs_plain": err,
          "row_sum_max_abs_err_vs_float64": err64,
          "torch_sum_ms": LIBRARY_MS["row_sum"],
          "row_sum_gb_per_s": WORK[("row_sum", "8192^2")][0] / (t_k * 1e-3)
          / 1e9, "n_1d": n, "tree_reduce_sum_f32": float(tree_f),
          "float64_sum": sum64, **rec})


def transpose_phase(dev, kernel_times, launches):
    """transpose() on 8192^2 float32 (the path: one K17 launch), exactly
    x.t(); K17 on a ragged int32 shape exactly; times beside
    x.t().contiguous()."""
    import torch

    from libhpc_tpu_torch.ops import transpose as tr

    x = rand_on((DENSE_N, DENSE_N), dev, DENSE_SEED + 1)
    torch.cuda.synchronize()
    tr.TRANSPOSE_LAUNCHES = 0
    y = tr.transpose(x)
    torch.cuda.synchronize()
    launches["transpose"] = {"transpose": tr.TRANSPOSE_LAUNCHES,
                             "need": {"transpose": 1}}
    if not torch.equal(y, x.t()):
        raise AssertionError("transpose: differs from x.t()")
    del y
    t = kernel_case("transpose", "8192^2", lambda: tr.transpose_pallas(x),
                    lambda: tr.transpose_pallas_torch(x), exact_plain,
                    kernel_times)
    WORK[("transpose", "8192^2")] = (2 * nbytes(x), 0)
    LIBRARY_MS["transpose"] = time_ms(lambda: x.t().contiguous())
    xi = (x[:5000, :3001] * 2**31).to(torch.int32)
    ti = kernel_case("transpose", "5000x3001/int32",
                     lambda: tr.transpose_pallas(xi),
                     lambda: tr.transpose_pallas_torch(xi), exact_plain,
                     kernel_times)
    WORK[("transpose", "5000x3001/int32")] = (2 * nbytes(xi), 0)
    del x, xi
    torch.cuda.synchronize()
    emit({"phase": "transpose", "shape": [DENSE_N, DENSE_N],
          **launches["transpose"], "equal_to_x_t": True,
          "transpose_ms": t[0], "plain_ms": t[1],
          "torch_t_contiguous_ms": LIBRARY_MS["transpose"],
          "gb_per_s": 2 * DENSE_N ** 2 * 4 / (t[0] * 1e-3) / 1e9,
          "ragged_int32_ms": ti[0], "ragged_int32_plain_ms": ti[1]})


def randn_on(shape, dev, seed, dtype=None):
    """Seeded standard normal float32 tensor on the card (cast to dtype)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(shape, device=dev, generator=g)
    return x if dtype is None else x.to(dtype)


def fp32_bound_ratio(c, oracle, abs_prod, k: int) -> float:
    """max |c - oracle| / (sqrt(k) 2^-24 (|A| |B|)), elementwise: the
    probabilistic rounding bound of a float32 sum of k products (Higham and
    Mary, SIAM J. Sci. Comput. 41(5), 2019). A float32 sum stays far
    below 1; a product of operands rounded to TF32 (unit roundoff 2^-11)
    lands above it."""
    bound = abs_prod * (k ** 0.5 * 2.0 ** -24)
    return float(((c.double() - oracle).abs() / bound.clamp_min(1e-300))
                 .max())


def matmul_phase(dev, kernel_times, launches):
    """K18 at 1024^2 and 8192^2 in float32, bfloat16 and float16 (the path:
    one K18 launch each, and one K17 launch: on A for float32, on B for the
    half widths) on mean-zero operands, so that rounding errors do not
    average out.
    float32 against its plain version and a float64 product: TOL_MM (the
    reference test's) at 1024^2, and at both sizes within the float32
    rounding bound (fp32_bound_ratio < 1), which torch.matmul with TF32 on
    must miss (the control, run once a size), with the FMA kernel's tile.
    bfloat16 and float16 against the float32 product of their rounded
    operands (TOL_MM_HALF). Every dtype with K17's time on its operand,
    the call's CUDA-graph time and the CUPTI device times of K17 and K18.
    Times beside torch.matmul (TF32 off)."""
    import torch

    from libhpc_tpu_torch.ops import matmul as mm
    from libhpc_tpu_torch.ops import transpose as tr

    rec, counts = {}, {}
    for n in (1024, DENSE_N):
        for dtype, kind in ((torch.float32, "matmul"),
                            (torch.bfloat16, "matmul_bf16"),
                            (torch.float16, "matmul_f16")):
            a = randn_on((n, n), dev, DENSE_SEED + 2, dtype)
            b = randn_on((n, n), dev, DENSE_SEED + 3, dtype)
            case, tag = f"{n}^2", f"{kind}_{n}"
            torch.cuda.synchronize()
            mm.MATMUL_LAUNCHES = 0
            tr.TRANSPOSE_LAUNCHES = 0
            c = mm.matmul_pallas(a, b)
            torch.cuda.synchronize()
            counts[kind] = counts.get(kind, 0) + mm.MATMUL_LAUNCHES
            counts["transpose"] = (counts.get("transpose", 0)
                                   + tr.TRANSPOSE_LAUNCHES)
            if c.dtype != dtype or c.shape != (n, n):
                raise AssertionError(f"matmul {case}: {c.dtype} {c.shape}")
            abs_prod = None
            if dtype == torch.float32:
                oracle = a.double() @ b.double()
                abs_prod = a.double().abs() @ b.double().abs()
                ratio = fp32_bound_ratio(c, oracle, abs_prod, n)
                in_tol = torch.allclose(c.double(), oracle, rtol=TOL_MM[0],
                                        atol=TOL_MM[1])
                ok = ratio < 1 and (n > 1024 or in_tol)
                torch.backends.cuda.matmul.allow_tf32 = True
                c32 = torch.matmul(a, b)
                torch.cuda.synchronize()
                torch.backends.cuda.matmul.allow_tf32 = False
                tf32_ratio = fp32_bound_ratio(c32, oracle, abs_prod, n)
                tf32_in_tol = torch.allclose(c32.double(), oracle,
                                             rtol=TOL_MM[0], atol=TOL_MM[1])
                if tf32_ratio < 1 or (n <= 1024 and tf32_in_tol):
                    raise AssertionError(
                        f"matmul {case}: torch.matmul with TF32 on passes "
                        f"(bound ratio {tf32_ratio}, within TOL_MM "
                        f"{tf32_in_tol}); the check cannot tell FP32 from "
                        "TF32")
                rec.update({f"{tag}_fp32_bound_ratio": ratio,
                            f"{tag}_within_tol_mm": in_tol,
                            f"{tag}_tf32_control_bound_ratio": tf32_ratio,
                            f"{tag}_tf32_control_max_abs_err":
                            max_err(c32.double(), oracle),
                            f"{tag}_tf32_control_within_tol_mm": tf32_in_tol})
                del c32
            else:
                oracle = (a.float() @ b.float()).double()
                ok = torch.allclose(c.double(), oracle, rtol=TOL_MM_HALF,
                                    atol=TOL_MM_HALF)
            err = max_err(c.double(), oracle)
            if not ok:
                raise AssertionError(f"matmul {case} {dtype}: off its "
                                     f"oracle by {err}")
            del c, oracle

            def check(got, want, what):
                e = max_err(got.float(), want.float())
                if abs_prod is not None:
                    # two float32 sums of the same products, each within
                    # the bound: within twice the bound of each other
                    r = fp32_bound_ratio(got, want.double(), abs_prod, n)
                    if r >= 2:
                        raise AssertionError(f"{what}: {r} times the float32 "
                                             f"bound, max |diff| {e}")
                elif not torch.allclose(got.float(), want.float(),
                                        rtol=TOL_MM_HALF, atol=TOL_MM_HALF):
                    raise AssertionError(f"{what}: max |diff| {e}")
                return e

            reps = 20 if n == 1024 else 3
            t = kernel_case(kind, case, lambda: mm.matmul_pallas(a, b),
                            lambda: mm.matmul_pallas_torch(a, b), check,
                            kernel_times, reps=reps)
            lib = time_ms(lambda: torch.matmul(a, b), reps=reps)
            WORK[(kind, case)] = (3 * nbytes(a), 2 * n ** 3)
            if n == DENSE_N:
                LIBRARY_MS[kind] = lib
            rec.update({f"{tag}_ms": t[0], f"{tag}_plain_ms": t[1],
                        f"{tag}_torch_matmul_ms": lib,
                        f"{tag}_max_abs_err_vs_plain": t[2],
                        f"{tag}_max_abs_err_vs_oracle": err,
                        f"{tag}_tflop_s": 2 * n ** 3 / (t[0] * 1e-3) / 1e12})
            # the call's device time without the host's gaps (graph
            # replay), and its split by kernel (CUPTI); K17 runs on A for
            # float32 (A^T), on B for the half widths (B^T)
            k18 = "fma_kernel" if dtype == torch.float32 else "wgmma"
            _, by_name = device_ms(lambda: mm.matmul_pallas(a, b), reps=3,
                                   want={k18: 1, "transpose": 1})
            split = {part: (sum(v for name, v in by_name.items()
                                if part in name) if by_name else None)
                     for part in (k18, "transpose")}
            k17_in = a if dtype == torch.float32 else b
            rec.update({
                f"{tag}_k17_ms": time_ms(
                    lambda: tr.transpose_pallas(k17_in), reps=reps),
                f"{tag}_graph_ms": graph_ms(lambda: mm.matmul_pallas(a, b),
                                            reps=reps),
                f"{tag}_device_k18_ms": split[k18],
                f"{tag}_device_k17_ms": split["transpose"]})
            if dtype == torch.float32:
                rec[f"{tag}_fma_tile"] = mm.fma_tile(
                    n, n, torch.cuda.get_device_properties(
                        dev).multi_processor_count)
            del a, b, abs_prod, k17_in
    launches["matmul"] = {**counts,
                          "need": {"matmul": 2, "matmul_bf16": 2,
                                   "matmul_f16": 2, "transpose": 6}}
    torch.cuda.synchronize()
    emit({"phase": "matmul", **launches["matmul"],
          "tf32": torch.backends.cuda.matmul.allow_tf32, **rec})


def box_sum64(a, r: int):
    """float64 2-D box sum of radius r with a zero halo (the oracle)."""
    from libhpc_tpu_torch.ops import stencil

    return stencil.blur2d_pallas_torch(a.double(), r)


BLUR_SWEEP = (1, 8, 32, 64)   # radii of K19 at 8192^2 (TMA)
BLUR_KERNEL = "blur2d_kernel"  # K19 (csrc/blur2d.cu), every instance


def blur_case(a, r, mode, reps=10):
    """K19 on `a` in load mode `mode` (its plan's, asserted) against its
    plain version at TOL_PLAIN, with its event time and GB/s (a read once,
    out written once)."""
    from libhpc_tpu_torch.ops import stencil

    plan = stencil.blur_plan(*a.shape, r, a.data_ptr())
    if plan.mode != mode:
        raise AssertionError(f"K19 {tuple(a.shape)} r {r}: plan mode "
                             f"{plan.mode}, expected {mode}")

    def call():
        return stencil.blur2d_pallas(a, r)

    err = close_plain(call(), stencil.blur2d_pallas_torch(a, r),
                      f"K19 {tuple(a.shape)} r {r}")
    ms = time_ms(call, reps=reps)
    return {"mode": mode, "band_rows": plan.band_rows, "ms": ms,
            "gb_per_s": 2 * a.numel() * 4 / ms / 1e6,
            "max_abs_err_vs_plain": err}


def blur_sweep(a, dev) -> dict:
    """K19 at the radii of BLUR_SWEEP on the 8192^2 input (TMA), and at
    r = 8 on 8191^2 (plain loads: rows of 8191 floats are no multiple of
    16 bytes)."""
    rec = {f"r{r}": blur_case(a, r, "tma") for r in BLUR_SWEEP}
    odd = rand_on((DENSE_N - 1, DENSE_N - 1), dev, DENSE_SEED + 5)
    rec["8191^2/r8"] = blur_case(odd, 8, "plain")
    del odd
    return rec


def stencil_phase(dev, kernel_times, launches):
    """K19 blur2d_pallas on 8192^2, r = 8 (the path: one launch, in the
    TMA load mode) against its plain version and a float64 box sum; the
    plain blur2d, the library yardstick F.avg_pool2d (count_include_pad,
    times (2r+1)^2; checked against K19 at 1e-3) and one F.conv2d with a
    ones weight (cuDNN, TF32 off) timed beside it; blur_sweep; then
    poisson5_apply on 2048^2 and poisson7_apply on 128^3 against csr_spmv
    of poisson2d/poisson3d."""
    import torch

    from libhpc_tpu_torch.bench import matrices
    from libhpc_tpu_torch.ops import spmv, stencil
    from libhpc_tpu_torch.sparse.csr import CSR

    r = 8
    a = rand_on((DENSE_N, DENSE_N), dev, DENSE_SEED + 4)
    torch.cuda.synchronize()
    stencil.BLUR_LAUNCHES = stencil.BLUR_TMA_LAUNCHES = 0
    stencil.BLUR_PLAIN_LAUNCHES = 0
    out = stencil.blur2d_pallas(a, r)
    torch.cuda.synchronize()
    launches["stencil"] = {"blur": stencil.BLUR_LAUNCHES,
                           "blur_tma": stencil.BLUR_TMA_LAUNCHES,
                           "blur_plain": stencil.BLUR_PLAIN_LAUNCHES,
                           "need": {"blur": 1, "blur_tma": 1}}
    if stencil.BLUR_PLAIN_LAUNCHES:
        raise AssertionError("K19 at 8192^2 took the plain loads")
    oracle = box_sum64(a, r)
    err64 = max_err(out.double(), oracle)
    if not torch.allclose(out.double(), oracle, rtol=TOL_PLAIN, atol=0):
        raise AssertionError(f"blur2d_pallas: off float64 by {err64}")
    del oracle
    case = "8192^2/r8"
    t = kernel_case("blur", case, lambda: stencil.blur2d_pallas(a, r),
                    lambda: stencil.blur2d_pallas_torch(a, r), close_plain,
                    kernel_times, reps=10)
    WORK[("blur", case)] = (nbytes(a, out), 2 * (2 * r + 1) * a.numel())
    cum = stencil.blur2d(a, r)
    err_cum = max_err(cum, out)
    assert_close(cum, out, "blur2d (cumsum form) vs K19", 1e-3, 1e-3)
    del cum
    t_cum = time_ms(lambda: stencil.blur2d(a, r), reps=10)
    w = torch.ones((1, 1, 2 * r + 1, 2 * r + 1), device=dev)
    a4 = a[None, None]

    def pool():
        # the zero-padded box mean over (2r+1)^2 cells, times their count
        return torch.nn.functional.avg_pool2d(
            a4, 2 * r + 1, 1, r, count_include_pad=True) * (2 * r + 1) ** 2

    def conv():
        return torch.nn.functional.conv2d(a4, w, padding=r)

    got = pool()[0, 0]
    err_pool = max_err(got, out)
    assert_close(got, out, "avg_pool2d box sum vs K19", 1e-3, 1e-3)
    LIBRARY_MS["blur"] = time_ms(pool, reps=10)
    err_conv = max_err(conv()[0, 0], out)
    t_conv = time_ms(conv, reps=10)
    del out, w, a4, got
    sweep = blur_sweep(a, dev)

    def vs_csr(A, u, got, what):
        y = spmv.csr_spmv(CSR.from_scipy(A, device=dev), u.reshape(-1))
        if not torch.allclose(got.reshape(-1), y, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{what}: max |diff| "
                                 f"{max_err(got.reshape(-1), y)} vs csr_spmv")
        return max_err(got.reshape(-1), y)

    u2 = a[:2048, :2048].contiguous()
    e5 = vs_csr(matrices.poisson2d(2048), u2, stencil.poisson5_apply(u2),
                "poisson5_apply 2048^2")
    u3 = a.reshape(-1)[:128 ** 3].reshape(128, 128, 128)
    e7 = vs_csr(matrices.poisson3d(128), u3, stencil.poisson7_apply(u3),
                "poisson7_apply 128^3")
    rec = {"poisson5_2048_ms": time_ms(lambda: stencil.poisson5_apply(u2)),
           "poisson7_128_ms": time_ms(lambda: stencil.poisson7_apply(u3))}
    del a, u2, u3
    torch.cuda.synchronize()
    emit({"phase": "stencil", "shape": [DENSE_N, DENSE_N], "radius": r,
          **launches["stencil"], "blur2d_pallas_ms": t[0],
          "plain_ms": t[1], "max_abs_err_vs_plain": t[2],
          "max_abs_err_vs_float64": err64,
          "bound_ms": WORK[("blur", case)][0] / PEAK_BYTES_S * 1e3,
          "blur_sweep": sweep, "blur2d_cumsum_ms": t_cum,
          "blur2d_cumsum_max_abs_err_vs_k19": err_cum,
          "avg_pool2d_ms": LIBRARY_MS["blur"],
          "avg_pool2d_max_abs_err_vs_k19": err_pool, "conv2d_ms": t_conv,
          "conv2d_max_abs_err_vs_k19": err_conv, "gb_per_s": WORK[("blur", case)][0] / (t[0] * 1e-3)
          / 1e9, "poisson5_max_abs_err_vs_csr": e5,
          "poisson7_max_abs_err_vs_csr": e7, **rec})


def grid_phase(dev):
    """The particle-write workload (bench/corpus.py:498-520): 2^20 seeded
    unit writes over 4096^2 into BlockGrid.create((256, 256), 16, 65536),
    touched in raster and in morton order, written by write_batch and
    write_batch_dense and read back; then a NestedGrid over the same
    domain. Every dense image equals a dense index_put_(accumulate=True)
    oracle exactly (unit writes sum exactly); writes/s from the host clock
    (median of 5, ending in a sync)."""
    import torch

    from libhpc_tpu_torch.sparse.grid import BlockGrid, NestedGrid

    n = 1 << 20
    g = torch.Generator(device=dev)
    g.manual_seed(DENSE_SEED + 5)
    xs = torch.randint(0, 4096, (n,), device=dev, generator=g,
                       dtype=torch.int32)
    ys = torch.randint(0, 4096, (n,), device=dev, generator=g,
                       dtype=torch.int32)
    vals = torch.ones(n, device=dev)
    want = torch.zeros((4096, 4096), device=dev).index_put_(
        (ys.long(), xs.long()), vals, accumulate=True)
    n_tiles = int((want.view(256, 16, 256, 16).sum((1, 3)) > 0).sum())
    grid0 = BlockGrid.create((256, 256), block_size=16, capacity=65536,
                             device=dev)
    rec = {}
    for order in ("raster", "morton"):
        grid = grid0.touch_batch(xs, ys, order=order)
        if int(grid.n_allocated()) != n_tiles:
            raise AssertionError(f"touch {order}: {int(grid.n_allocated())} "
                                 f"tiles, expected {n_tiles}")
        for name, fn in (("write_batch", grid.write_batch),
                         ("write_batch_dense", grid.write_batch_dense)):
            if not torch.equal(fn(xs, ys, vals).todense(), want):
                raise AssertionError(f"{order} {name}: differs from the "
                                     "dense oracle")
        written = grid.write_batch(xs, ys, vals)
        if not torch.equal(written.read_batch(xs, ys), want[ys, xs]):
            raise AssertionError(f"{order} read_batch differs")
        rec[f"touch_{order}_ms"] = wall_ms(
            lambda o=order: grid0.touch_batch(xs, ys, order=o), reps=5)
        if order == "raster":
            rec["write_batch_ms"] = wall_ms(
                lambda: grid.write_batch(xs, ys, vals), reps=5)
            rec["write_batch_dense_ms"] = wall_ms(
                lambda: grid.write_batch_dense(xs, ys, vals), reps=5)
            rec["read_batch_ms"] = wall_ms(
                lambda: written.read_batch(xs, ys), reps=5)
    del grid, written
    nested0 = NestedGrid.create((16, 16), mid_grid=(16, 16), block_size=16,
                                cap_mid=256, cap_leaf=65536, device=dev)
    nested = nested0.touch_batch(xs, ys)
    if (int(nested.n_leaf) != n_tiles
            or not torch.equal(nested.write_batch(xs, ys, vals).todense(),
                               want)):
        raise AssertionError("NestedGrid differs from the dense oracle")
    rec["nested_touch_ms"] = wall_ms(lambda: nested0.touch_batch(xs, ys),
                                     reps=5)
    rec["nested_write_batch_ms"] = wall_ms(
        lambda: nested.write_batch(xs, ys, vals), reps=5)
    del nested, nested0, grid0, want
    torch.cuda.synchronize()
    emit({"phase": "grid", "writes": n, "extent": [4096, 4096],
          "tiles_touched": n_tiles, "equal_to_dense_oracle": True, **rec,
          **{f"{k[:-3]}_mwrites_per_s": n / (v * 1e-3) / 1e6
             for k, v in rec.items()}})


def hbm_phase(dev) -> None:
    """The harness's two speed-of-light probes beside the data sheet: the
    in-place x *= c stream on 128 MB (read + write) and full sums of
    512 MB (read only), delta-method CUDA-event times."""
    from libhpc_tpu_torch.bench import harness

    mix = harness.measure_hbm_bandwidth(device=dev)
    read = harness.measure_hbm_read_bandwidth(device=dev)
    emit({"phase": "hbm", "stream_rw_gb_per_s": mix / 1e9,
          "read_gb_per_s": read / 1e9,
          "data_sheet_gb_per_s": PEAK_BYTES_S / 1e9,
          "stream_rw_of_data_sheet": mix / PEAK_BYTES_S,
          "read_of_data_sheet": read / PEAK_BYTES_S})


# overlap_chip._time_sweep's chain lengths and reps: each w launches K20
# (iters + small) * (1 + reps) times (one warm chain of each length)
SWEEP_CHAINS = (96 + 12) * (1 + 4)


def overlap_phase(dev, kernel_times, launches) -> None:
    """K20's sweep over every w of WS at the reference's 512 MB, through
    overlap_chip.run (the path: counter zeroed before, read after); raises
    if t(64) <= t(0), which would mean the chain was eliminated; then K20
    against its plain version on 512 MB of seeded uniform values at w = 0
    and w = 64, with times."""
    import torch

    from libhpc_tpu_torch.bench import overlap_chip as oc

    torch.cuda.synchronize()
    oc.SWEEP_LAUNCHES = 0
    rec = oc.run(512, device=dev)
    torch.cuda.synchronize()
    launches["overlap"] = {"sweep": oc.SWEEP_LAUNCHES,
                           "need": {"sweep": len(oc.WS) * SWEEP_CHAINS}}
    us = rec["us_per_step"]
    if us["64"] <= us["0"]:
        raise AssertionError(f"overlap: t(64) {us['64']} us <= t(0) "
                             f"{us['0']} us: the chain was eliminated")
    steps = 512 * 1024 * 1024 // (oc.ROWS * oc.LANE * 4)
    x = rand_on((steps * oc.ROWS, oc.LANE), dev, DENSE_SEED + 6)
    t = {}
    for w in (0, 64):
        case = f"512MB/w{w}"
        t[w] = kernel_case("overlap_sweep", case,
                           lambda w=w: oc._sweep_step(x, w),
                           lambda w=w: oc._sweep_step_torch(x, w),
                           close_plain, kernel_times, reps=10)
        WORK[("overlap_sweep", case)] = (nbytes(x) + steps * 8 * oc.LANE * 4,
                                         2 * w * x.numel())
    del x
    torch.cuda.synchronize()
    emit({"phase": "overlap", **launches["overlap"], "block_mb":
          rec["block_mb"], "steps": steps, "us_per_step": us,
          "stream_gb_per_s": rec["stream_gb_per_s"],
          "compute_unit_us": rec["compute_unit_us"], "w_star": rec["w_star"],
          "overlap_efficiency": rec["overlap_efficiency"],
          **{f"w{w}_ms": r[0] for w, r in t.items()},
          **{f"w{w}_plain_ms": r[1] for w, r in t.items()},
          **{f"w{w}_max_abs_err_vs_plain": r[2] for w, r in t.items()},
          **{f"w{w}_bound_ms": max(
              WORK[("overlap_sweep", f"512MB/w{w}")][0] / PEAK_BYTES_S,
              WORK[("overlap_sweep", f"512MB/w{w}")][1] / PEAK_F32_OPS_S)
             * 1e3 for w in t}})


# K21b's ring shapes timed on the 2^17 x 4 KB case: (stages, rows a stage)
DMA_SWEEP = ((2, 32), (3, 32), (4, 16), (4, 32), (4, 64), (6, 32), (8, 16),
             (8, 32), (2, 128), (3, 128))

# launches of each microarch kernel when its bench runs at its defaults:
# (iters + iters_small) * (1 + reps) of the bench's time_iterated call
MICROARCH_NEED = {"lane_shuffle": 9 * 4, "dma_gather": 9 * 4,
                  "cmpex_roll": 18 * 4, "cmpex_reshape": 18 * 4}


def microarch_phase(dev, kernel_times, launches) -> None:
    """Every bench of microarch.ALL at its defaults (the path: counters
    zeroed before, read after; each record has the reference's keys and
    no error), then each K21 kernel past the 50 MB L2, exactly against its
    plain version: K21a at S = 1024 with 1024 tiles (512 MB of indices),
    K21b gathering 2^17 rows of 4 KB from a 256 MB table (G = 256), K21c
    and K21d on 2^20 rows (512 MB); times beside torch.take_along_dim and
    index_select."""
    import contextlib
    import io

    import torch

    from libhpc_tpu_torch.bench import microarch as ma

    torch.cuda.synchronize()
    ma.LANE_SHUFFLE_LAUNCHES = ma.DMA_GATHER_LAUNCHES = 0
    ma.CMPEX_ROLL_LAUNCHES = ma.CMPEX_RESHAPE_LAUNCHES = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for fn in ma.ALL.values():
            fn(device=dev)
    torch.cuda.synchronize()
    launches["microarch"] = {
        "lane_shuffle": ma.LANE_SHUFFLE_LAUNCHES,
        "dma_gather": ma.DMA_GATHER_LAUNCHES,
        "cmpex_roll": ma.CMPEX_ROLL_LAUNCHES,
        "cmpex_reshape": ma.CMPEX_RESHAPE_LAUNCHES,
        "need": MICROARCH_NEED}
    records = [json.loads(line) for line in buf.getvalue().splitlines()]
    if ({r.get("bench") for r in records} != set(ma.ALL)
            or any("error" in r for r in records)):
        raise AssertionError(f"microarch: bench records {records}")
    for r in records:
        emit(r)

    g = torch.Generator(device=dev)
    g.manual_seed(DENSE_SEED + 7)
    s, n_tiles = 1024, 1024
    tab = rand_on((s, 128), dev, DENSE_SEED + 8)
    idx = torch.randint(0, 128, (n_tiles * s, 128), device=dev, generator=g,
                        dtype=torch.int32)
    rec = {"lane_shuffle": kernel_case(
        "lane_shuffle", "S1024/tiles1024", lambda: ma.lane_shuffle(tab, idx),
        lambda: ma.lane_shuffle_torch(tab, idx), exact_plain, kernel_times,
        reps=10)}
    WORK[("lane_shuffle", "S1024/tiles1024")] = (
        nbytes(tab, idx) + n_tiles * s * 128 * 4, 0)
    idx64 = idx.view(n_tiles, s, 128).long()
    tab3 = tab.expand(n_tiles, s, 128)
    if not torch.equal(torch.take_along_dim(tab3, idx64, dim=2).view(-1, 128),
                       ma.lane_shuffle(tab, idx)):
        raise AssertionError("lane_shuffle: differs from take_along_dim")
    LIBRARY_MS["lane_shuffle"] = time_ms(
        lambda: torch.take_along_dim(tab3, idx64, dim=2), reps=10)
    del tab, idx, idx64, tab3

    n_table, n_gather, R, G = 1 << 16, 1 << 17, 8, 256
    table = rand_on((n_table * R, 128), dev, DENSE_SEED + 9)
    rows = torch.randint(0, n_table, (n_gather,), device=dev, generator=g,
                         dtype=torch.int32)
    rec["dma_gather"] = kernel_case(
        "dma_gather", "2^17x4KB", lambda: ma.dma_gather(rows, table, R, G),
        lambda: ma.dma_gather_torch(rows, table, R), exact_plain,
        kernel_times, reps=10)
    # the table rows this run's indices need, each read once
    distinct = int(torch.unique(rows).numel())
    WORK[("dma_gather", "2^17x4KB")] = (
        nbytes(rows) + (distinct + n_gather) * R * 128 * 4, 0)
    table2 = table.view(n_table, R * 128)
    LIBRARY_MS["dma_gather"] = time_ms(
        lambda: table2.index_select(0, rows), reps=10)
    stages, stage_rows = ma.gather_plan(R, G)
    # past the L2 a repeated row is read again: each gather read once
    one_read_ms = (nbytes(rows) + 2 * n_gather * R * 128 * 4) / PEAK_BYTES_S
    want = ma.dma_gather_torch(rows, table, R)
    sweep = {}
    for st, sr in DMA_SWEEP:
        def gather(st=st, sr=sr):
            return ma.dma_gather(rows, table, R, G, stages=st, stage_rows=sr)

        if not torch.equal(gather(), want):
            raise AssertionError(f"dma_gather: a ring of {st} x {sr} rows "
                                 "differs from its plain version")
        sweep[f"{st}x{sr}"] = time_ms(gather, reps=10)
    del table, rows, table2, want

    x = rand_on((1 << 20, 128), dev, DENSE_SEED + 10)
    for kind in ("cmpex_roll", "cmpex_reshape"):
        rec[kind] = kernel_case(
            kind, "2^20", lambda k=kind: getattr(ma, k)(x),
            lambda k=kind: getattr(ma, f"{k}_torch")(x), exact_plain,
            kernel_times, reps=10)
        WORK[(kind, "2^20")] = (2 * nbytes(x), x.numel())
    del x
    torch.cuda.synchronize()
    emit({"phase": "microarch", **launches["microarch"],
          "dma_gather_distinct_rows": distinct,
          "dma_gather_stages": stages, "dma_gather_stage_rows": stage_rows,
          "dma_gather_rows_in_flight_per_block": stages * stage_rows,
          "dma_gather_bound_one_read_a_gather_ms": one_read_ms * 1e3,
          "dma_gather_sweep_ms": sweep,
          **{f"{k}_ms": r[0] for k, r in rec.items()},
          **{f"{k}_plain_ms": r[1] for k, r in rec.items()},
          **{f"{k}_library_ms": LIBRARY_MS.get(k) for k in rec},
          **{f"{k}_gb_per_s": WORK[(k, c)][0] / (rec[k][0] * 1e-3) / 1e9
             for k, c in (("lane_shuffle", "S1024/tiles1024"),
                          ("dma_gather", "2^17x4KB"),
                          ("cmpex_roll", "2^20"),
                          ("cmpex_reshape", "2^20"))}})


SORT_SPLIT_ARG = "--sort-split"


def sort_split_phase() -> None:
    """Where the 500M sort's and argsort's device time goes, and K8 and
    K11 alone, profiled in a child process of its own (``chip_smoke.py
    --sort-split``): in this process, after its other profiles, the
    profiler lost records of those sorts (K8's among them)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          SORT_SPLIT_ARG], capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        raise AssertionError(f"sort_split: the profiling process failed "
                             f"({res.returncode}): {res.stderr[-3000:]}")
    emit(json.loads(res.stdout.strip().splitlines()[-1]))


def cupti_split(call, want: dict, labels: dict) -> dict:
    """One call profiled (CUPTI): its device time and that of the kernels
    whose names hold each key of `labels` (want: the launches of each a
    call, to tell a lossy profile), their shares, and the torch ops
    left."""
    total, split = device_ms(call, reps=1, want=want)
    complete = bool(total)
    if not complete:    # keep what a lossy profile saw, marked as such
        total, split = device_ms(call, reps=1)
    if not total:
        raise AssertionError("sort_split: the profiler saw no device work")
    kernels = {label: 0.0 for label in labels.values()}
    torch_ops = {}
    for name, ms in split.items():
        label = next((lb for k, lb in labels.items() if k in name), None)
        if label:
            kernels[label] += ms
        else:
            short = name.split("<")[0].split("(")[0].replace("void ", "")
            torch_ops[short] = torch_ops.get(short, 0.0) + ms
    return {"cupti_ms": total, "records_complete": complete,
            **{f"{k}_ms": v for k, v in kernels.items()},
            **{f"{k}_share": v / total for k, v in kernels.items()},
            "torch_ops_ms": sum(torch_ops.values()),
            "torch_ops_top_ms": dict(sorted(torch_ops.items(),
                                            key=lambda kv: -kv[1])[:4])}


def sort_split_profile() -> dict:
    """One 500M sort and one 500M argsort profiled (CUPTI), kernels summed
    by name (K8 or K11, the merges, their split searches, the torch ops
    left); then K8 and K11 alone on 2^26 keys in 2^LOG2C_KERNEL chunks, as
    phases sort_kernels and kv_kernels run them."""
    import torch

    from libhpc_tpu_torch.ops import sort_merge as sm
    from libhpc_tpu_torch.ops import sort_merge_kv as kv

    n = 500_000_000
    ku = sort_keys(n, torch.device("cuda")).view(torch.uint32)
    rec = {"phase": "sort_split", "n": n}
    for name, mod, call, chunk, merge in (
            ("sort", sm, lambda: sm.merge_sort_u32(ku), "K8", "K9"),
            ("argsort", kv, lambda: kv.merge_argsort_u32(ku), "K11",
             "K12")):
        need = expected_sort_launches(n, mod.DEFAULT_LOG2C, mod)
        rec[name] = cupti_split(
            call, {CHUNK_KERNEL: need["chunk"], MERGE_KERNEL: need["merge"],
                   SPLIT_KERNEL: need["split"]},
            {CHUNK_KERNEL: f"{chunk} {CHUNK_KERNEL}",
             MERGE_KERNEL: f"{merge} {MERGE_KERNEL}",
             SPLIT_KERNEL: SPLIT_KERNEL})
    P = 1 << 26
    x = ku.view(torch.int32)[:P].contiguous()
    v = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    del ku
    PAD = 1 << sm.DEFAULT_LOG2W
    at = dict(pad_rows=PAD // 128, total_rows=(2 * PAD + P + 2048) // 128,
              alternate=True, invert=False, unflip=False)
    rec["K8_alone_2^26_cupti_ms"] = cupti_kernels(
        lambda: sm.chunk_sort_kernel(x, log2c=sm.LOG2C_KERNEL, **at),
        (CHUNK_KERNEL,))[CHUNK_KERNEL]
    rec["K11_alone_2^26_cupti_ms"] = cupti_kernels(
        lambda: kv.chunk_sort_kv_kernel(x, v, log2c=kv.LOG2C_KERNEL, **at),
        (CHUNK_KERNEL,))[CHUNK_KERNEL]
    return rec


CORPUS_ARG = "--corpus"
# the launch counters the corpus child reads: name -> (module, attribute)
CORPUS_COUNTERS = {
    "spmv": ("libhpc_tpu_torch.ops.spmv_sbell", "SPMV_LAUNCHES"),
    "near": ("libhpc_tpu_torch.ops.spmv_sbell", "NEAR_LAUNCHES"),
    "far": ("libhpc_tpu_torch.ops.far_sbell", "FAR_LAUNCHES"),
    "chunk": ("libhpc_tpu_torch.ops.sort_merge", "CHUNK_LAUNCHES"),
    "merge": ("libhpc_tpu_torch.ops.sort_merge", "MERGE_LAUNCHES"),
    "pair": ("libhpc_tpu_torch.ops.sort_merge", "PAIR_LAUNCHES"),
    "split": ("libhpc_tpu_torch.ops.sort_merge", "SPLIT_LAUNCHES"),
    "scan_f32": ("libhpc_tpu_torch.ops.scan", "SCAN_F32_LAUNCHES"),
    "hist": ("libhpc_tpu_torch.ops.histogram", "HIST_LAUNCHES"),
    "transpose": ("libhpc_tpu_torch.ops.transpose", "TRANSPOSE_LAUNCHES"),
    "blur": ("libhpc_tpu_torch.ops.stencil", "BLUR_LAUNCHES"),
}
# corpus bench -> the counters that must move in it. K1-K3 run fused (one
# "spmv" launch a matvec); merge counts K9 and K10, pair the K10 ones
CORPUS_NEED = {
    "transpose": ("transpose",),
    "blur": ("blur",),
    "sort": ("chunk", "merge", "pair", "split"),
    "scan_hist": ("scan_f32", "hist"),
    "sbell": ("spmv",),
    "spmm_cg": ("spmv",),
    "scale": ("spmv",),
    "amg": ("spmv",),
}


def corpus_child() -> dict:
    """corpus.main([name]) for each bench of corpus.ALL at its defaults
    (the records go to stdout as the corpus prints them), every counter of
    CORPUS_COUNTERS zeroed before a bench and read after it; each SBELL
    container the byte model is asked about (the sbell, scale records),
    with its real bytes (sbell_work) and far-set type; the cuDNN TF32 flag
    at every convolution. Returns that summary."""
    import importlib

    import torch
    import torch.nn.functional as F

    from libhpc_tpu_torch.bench import corpus, harness
    from libhpc_tpu_torch.sparse.sbell import FarPane

    mods = {k: (importlib.import_module(m), a)
            for k, (m, a) in CORPUS_COUNTERS.items()}
    sbell_seen = []
    byte_model = harness.format_spmv_rw_bytes

    def seen_bytes(fmt, obj, m, n):
        if fmt == "sbell":
            meta = torch.device("meta")
            x3 = torch.empty((obj.n_panes + 2, 8, 128), device=meta)
            out = torch.empty((obj.n_stripes + 2, 8, 128), device=meta)
            far = isinstance(obj.far, FarPane)
            sbell_seen.append({
                "rows": m, "dtype": str(obj.vflat.dtype),
                "far": type(obj.far).__name__,
                "real_bytes": sbell_work(obj, x3, out, True, far)[0],
                "model_bytes": sum(byte_model(fmt, obj, m, n))})
        return byte_model(fmt, obj, m, n)

    conv2d = F.conv2d
    tf32_at_conv = []

    def conv_seen(*a, **kw):
        tf32_at_conv.append(torch.backends.cudnn.allow_tf32
                            or torch.backends.cuda.matmul.allow_tf32)
        return conv2d(*a, **kw)

    harness.format_spmv_rw_bytes = seen_bytes
    F.conv2d = conv_seen
    counts, seconds = {}, {}
    cudnn_tf32_default = torch.backends.cudnn.allow_tf32
    for name in corpus.ALL:
        for mod, attr in mods.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        corpus.main([name])
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        counts[name] = {k: getattr(mod, attr)
                        for k, (mod, attr) in mods.items()
                        if getattr(mod, attr)}
    return {"counters": counts, "seconds": seconds,
            "sbell_containers": sbell_seen,
            "cudnn_tf32_default": cudnn_tf32_default,
            "tf32_at_conv": tf32_at_conv}


def check_corpus(records, child) -> None:
    """The corpus phase's gates (phase 29h)."""
    from libhpc_tpu_torch.bench import corpus

    names = [r["bench"] for r in records]
    want = [n for recs in corpus.RECORDS.values() for n in recs]
    bad = [r for r in records if "error" in r]
    if bad or names != want:
        raise AssertionError(f"corpus: error records {bad}; records "
                             f"{names}, expected {want}")
    by_name = {r["bench"]: r for r in records}
    wrong = [n for n in corpus.GATED if by_name[n].get("correct") is not True]
    if wrong:
        raise AssertionError(f"corpus: not correct: {wrong}")
    for bench, need in CORPUS_NEED.items():
        idle = [k for k in need if not child["counters"][bench].get(k)]
        if idle:
            raise AssertionError(f"corpus {bench}: {idle} never launched: "
                                 f"{child['counters'][bench]}")
    if by_name["spmv_sbell_100m_chunked"]["launches"] != 1:
        raise AssertionError("corpus: the 103M-nnz SpMV took "
                             f"{by_name['spmv_sbell_100m_chunked']} "
                             "fused launches a matvec, expected 1")
    if not any(c["far"] == "FarPane" for c in child["sbell_containers"]):
        raise AssertionError("corpus: no SBELL with a FarPane, so K3 "
                             "never ran fused")
    if not child["tf32_at_conv"] or any(child["tf32_at_conv"]):
        raise AssertionError(f"corpus: TF32 at the convolution: "
                             f"{child['tf32_at_conv'][:4]}")


def corpus_phase() -> None:
    """Phase 29h: the corpus in a child process (corpus_child), its
    gates, then entry()'s CG step on the card against the CPU."""
    import numpy as np
    import torch

    from libhpc_tpu_torch import dryrun

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          CORPUS_ARG], capture_output=True, text=True,
                         timeout=600)
    child_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"corpus: the child process failed "
                             f"({res.returncode}): {res.stdout[-2000:]} "
                             f"{res.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    records, child = lines[:-1], lines[-1]
    check_corpus(records, child)
    step, args = dryrun.entry()
    y = step(*args).cpu().numpy()
    step_c, args_c = dryrun.entry(device="cpu")
    yc = step_c(*args_c).numpy()
    if y.shape != yc.shape or not np.allclose(y, yc, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"entry: the card's CG step differs from the "
                             f"CPU's by {np.abs(y - yc).max()}")
    emit({"phase": "corpus", "records": records, "child_s": child_s,
          **child, "entry_max_abs_err": float(np.abs(y - yc).max())})


def library_phase(dev) -> None:
    """One torch.sparse CSR matvec (cuSPARSE) of each SpMV kernel's matrix:
    the library call computing the same product as K1-K7. Run after every
    profile: in a run where cuSPARSE had been called, later profiles saw
    no device work."""
    from libhpc_tpu_torch.bench import matrices

    t = {"cant_like": csr_library_ms(matrices.load_or_synthesize("cant"),
                                     dev),
         "poisson3072": csr_library_ms(matrices.poisson2d(3072), dev),
         "poisson1024": csr_library_ms(matrices.poisson2d(1024), dev)}
    LIBRARY_MS["near"] = LIBRARY_MS["far"] = LIBRARY_MS["spmv"] = \
        t["cant_like"]
    LIBRARY_MS["dia"] = LIBRARY_MS["dia_probe"] = t["poisson3072"]
    LIBRARY_MS["sell"] = LIBRARY_MS["sellp"] = t["poisson1024"]
    emit({"phase": "library", **{f"torch_sparse_csr_mv_{k}_ms": v
                                 for k, v in t.items()}})


def check_launches(spmv: int, near: int, far: int, matvecs: int) -> None:
    """Exactly one fused SpMV launch a main-path matvec, and no near-only
    or far-only launch."""
    if spmv != matvecs or near or far or matvecs < 1:
        raise AssertionError(f"main path launched the fused SpMV {spmv}, "
                             f"near {near}, far {far} times for {matvecs} "
                             "matvecs")


def check_family_launches(launches: dict) -> None:
    """Each path's kernel launched at least once per matvec it made."""
    for path, rec in launches.items():
        for kernel in ("dia", "dia_probe", "sell", "sellp"):
            if kernel not in rec:
                continue
            need = (rec["probes"] if kernel == "dia_probe"
                    else rec["matvecs"] * rec.get("per_matvec", 1))
            if rec[kernel] < max(need, 1):
                raise AssertionError(f"{path}: {kernel} launched "
                                     f"{rec[kernel]} times for {need} calls")
        # the sort and histogram paths: exactly the launches their sizes
        # call for, and at least one of each
        for kernel, need in rec.get("need", {}).items():
            if rec[kernel] != need or (need < 1 and kernel != "pair"):
                raise AssertionError(f"{path}: {kernel} launched "
                                     f"{rec[kernel]} times, expected {need}")


def kernel_entry(kernel_times, kind, name, source, replaces, launches,
                 cases) -> dict:
    """The kernels line's row of `kind` over its `cases`."""
    ms = sum(kernel_times[kind][c][0] for c in cases)
    plain_ms = sum(kernel_times[kind][c][1] for c in cases)
    # each case's bound is the larger of its two times; the cases' sum
    # is split by the kind that bounds each (K20's w = 0 and w = 64
    # fall on both sides of the ridge)
    t_bytes = t_ops = 0.0
    for c in cases:
        tb = WORK[(kind, c)][0] / PEAK_BYTES_S * 1e3
        to = WORK[(kind, c)][1] / OPS_PEAK.get(kind, PEAK_F32_OPS_S) * 1e3
        if tb >= to:
            t_bytes += tb
        else:
            t_ops += to
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(e for _, _, e in
                               kernel_times[kind].values()),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": t_bytes + t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": LIBRARY_MS.get(kind)}


def run(dev, native_build):
    """Phases 1-30 on `dev`; returns the {"kernels": [...]} record.
    native_build: the future of the native library's build (seconds)."""
    import torch

    from libhpc_tpu_torch.bench import matrices
    from libhpc_tpu_torch.ops import far_sbell, spmv_sbell
    from libhpc_tpu_torch.sparse.sbell import SBELL

    kernel_times = {k: {} for k in (
        "near", "far", "spmv", "dia", "dia_probe", "cg_vectors", "symgs",
        "sell",
        "sellp", "sort_chunk",
        "sort_chunk_staged", "sort_merge_level", "sort_merge_pair",
        "sort_split_search",
        "histogram", "sort_chunk_kv", "sort_chunk_kv_staged",
        "sort_merge_kv_level", "sort_merge_kv_pair", "scan_int",
        "scan_f32", "row_sum", "transpose", "matmul", "matmul_bf16",
        "matmul_f16", "blur", "overlap_sweep", "lane_shuffle", "dma_gather", "cmpex_roll",
        "cmpex_reshape")}
    sb_cant = A_cant = None
    for name in ("cant", "pwtk"):
        t0 = time.perf_counter()
        A = matrices.load_or_synthesize(name)
        sb = SBELL.from_scipy(A, device=dev)
        emit({"phase": "build", "matrix": name,
              "host_build_s": time.perf_counter() - t0})
        sbd = spmv_phase(name, A, sb, dev, kernel_times)
        pane_chain_phase(name, A, sbd, dev)
        spmv_phase(name, A, sb.astype_values(torch.bfloat16), dev,
                   kernel_times)
        if name == "cant":
            sb_cant, A_cant = sbd, A
        del sbd, sb, A

    spmv_sbell.SPMV_LAUNCHES = 0
    spmv_sbell.NEAR_LAUNCHES = 0
    far_sbell.FAR_LAUNCHES = 0
    matvecs = cg_phase(A_cant, sb_cant, dev)
    spmv = spmv_sbell.SPMV_LAUNCHES
    near, far = spmv_sbell.NEAR_LAUNCHES, far_sbell.FAR_LAUNCHES
    csr_cg_phase(dev)
    check_launches(spmv, near, far, matvecs)
    del sb_cant, A_cant

    family = {}

    A3 = matrices.poisson2d(3072)
    dia_phase(A3, dev, kernel_times, family)
    dia_cg_phase(A3, dev, family)
    cg_vectors_phase(dev, kernel_times, family)
    del A3
    symgs_phase(dev, kernel_times, family)
    dia_xla_phase(dev)
    A_p = matrices.poisson2d(1024)
    sell_phase(A_p, dev, kernel_times, family)
    sellp_phase(A_p, dev, kernel_times, family)
    del A_p

    keys = sort_path(500_000_000, dev, [1 << 29], family, "sort")
    sort_path(100_000_000, dev, [1 << 26, 1 << 24, 1 << 24], family,
              "sort_segmented")
    sort_kernels_phase(keys, kernel_times)
    radix_phase(dev)
    histogram_phase(keys, kernel_times, family)
    argsort_phase(keys, family)
    sort_kv_segmented_phase(dev, family)
    kv_kernels_phase(dev, kernel_times)
    scan_phase(keys, dev, kernel_times, family)
    del keys
    reduce_phase(dev, kernel_times, family)
    transpose_phase(dev, kernel_times, family)
    matmul_phase(dev, kernel_times, family)
    stencil_phase(dev, kernel_times, family)
    grid_phase(dev)
    hbm_phase(dev)
    overlap_phase(dev, kernel_times, family)
    microarch_phase(dev, kernel_times, family)
    sort_split_phase()
    # the solver family and the other formats, after every profile of the
    # phases before (the formats phase calls torch.sparse, cuSPARSE): the
    # AMG solves' checked launches join the main path's K1-K3 counts
    amg_fused, amg_far, amg_near = amg_phase(dev)
    dist_launches = dist_phase(dev)
    multigrid_phase(dev)
    precision_phase(dev)
    formats_phase(dev)
    spgemm_phase(dev)
    runtime_phase(dev, native_build)
    corpus_phase()
    check_family_launches(family)
    library_phase(dev)
    emit({"phase": "launches", "spmv": spmv, "near": near, "far": far,
          "matvecs": matvecs, "amg_pcg_fused": amg_fused,
          "amg_pcg_fused_far_pane": amg_far, "amg_pcg_near": amg_near,
          "dist": dist_launches,
          **family})
    torch.cuda.synchronize()

    def entry(*args):
        return kernel_entry(kernel_times, *args)

    spmv_src = "libhpc_tpu_torch/csrc/sbell_spmv.cu"
    merge_src = "libhpc_tpu_torch/csrc/sort_merge.cu"
    sort_paths = {k: family["sort"][k] + family["sort_segmented"][k]
                  for k in ("chunk", "merge", "pair", "split")}
    kv_paths = {k: family["argsort"][k] + family["sort_kv_segmented"][k]
                for k in ("chunk", "merge", "pair", "split")}
    chunk_src = "libhpc_tpu_torch/csrc/sort_chunk.cu"
    scan_src = "libhpc_tpu_torch/csrc/scan.cu"
    dia_src = "libhpc_tpu_torch/csrc/dia.cu"
    mm_src = "libhpc_tpu_torch/csrc/matmul.cu"
    ma_src = "libhpc_tpu_torch/csrc/microarch.cu"
    cant = ["cant/float32"]
    return {"kernels": [
        # K1/K2 and K3 are modes of one kernel; the main path runs their
        # functions fused, one launch a matvec: each row counts the
        # launches that ran its function (the CG path's, the AMG solves'
        # and the distributed paths' (two near launches a DistSBELL
        # matvec); K3's only where a FarPane was fused in), and times its
        # mode alone
        entry("near", "sbell_near", spmv_src,
              "libhpc_tpu/ops/spmv_pallas.py:59",
              spmv + amg_fused + amg_near + dist_launches, cant),
        entry("near", "sbell_near_ranged", spmv_src,
              "libhpc_tpu/ops/spmv_pallas.py:92",
              spmv + amg_fused + amg_near + dist_launches, cant),
        entry("far", "far_pane", spmv_src,
              "libhpc_tpu/ops/far_pallas.py:33", spmv + amg_far, cant),
        entry("spmv", "sbell_spmv_fused", spmv_src,
              "libhpc_tpu/ops/spmv_pallas.py:59",
              spmv + amg_fused + dist_launches, cant),
        entry("dia", "dia", dia_src, "libhpc_tpu/ops/dia_pallas.py:100",
              family["dia"]["dia"] + family["dia_cg"]["dia"]
              + family["symgs"]["dia"], ["poisson3072"]),
        entry("dia_probe", "dia_probe", dia_src,
              "libhpc_tpu/ops/dia_pallas.py:150",
              family["dia"]["dia_probe"], ["poisson3072"]),
        # no Pallas kernel: XLA fused the reference's CG vector work
        entry("cg_vectors", "cg_vectors", "libhpc_tpu_torch/csrc/cg_vectors.cu",
              "libhpc_tpu/ops/solver.py:cg (XLA's fusion)",
              family["dia_cg"]["cg_vectors"]
              + family["cg_vectors"]["cg_vectors"], ["2^24/float32"]),
        # no kernel of either package: HPCG's smoother, one V-cycle's
        # launches at 256^3
        entry("symgs", "symgs_dia", "libhpc_tpu_torch/csrc/symgs_dia.cu",
              "none: HPCG's SymGS (no Gauss-Seidel kernel in libhpc_tpu)",
              family["symgs"]["symgs"], ["256^3"]),
        entry("sell", "sell", "libhpc_tpu_torch/csrc/sell.cu",
              "libhpc_tpu/ops/ell_pallas.py:191",
              family["sell_poisson1024"]["sell"]
              + family["sell_band2^20"]["sell"],
              ["poisson1024/near", "poisson1024/wide"]),
        entry("sellp", "sellp", "libhpc_tpu_torch/csrc/sellp.cu",
              "libhpc_tpu/ops/sellp.py:213", family["sellp"]["sellp"],
              ["poisson1024"]),
        entry("sort_chunk", "sort_chunk",
              "libhpc_tpu_torch/csrc/sort_chunk.cu",
              "libhpc_tpu/ops/sort_pallas.py:131",
              sort_paths["chunk"], ["2^26/asc"]),
        entry("sort_merge_level", "sort_merge_level", merge_src,
              "libhpc_tpu/ops/sort_pallas.py:301",
              sort_paths["merge"] - sort_paths["pair"], ["2^26/r2^16"]),
        entry("sort_merge_pair", "sort_merge_pair", merge_src,
              "libhpc_tpu/ops/sort_pallas.py:430", sort_paths["pair"],
              ["2^26+2^24/desc1"]),
        # the split search fed K9/K10/K12 by scalar prefetch on the TPU
        entry("sort_split_search", "sort_split_search", merge_src,
              "libhpc_tpu/ops/sort_pallas.py:198",
              sort_paths["split"] + kv_paths["split"],
              ["sort_merge_level/2^26/r2^16"]),
        entry("histogram", "histogram", "libhpc_tpu_torch/csrc/histogram.cu",
              "libhpc_tpu/ops/histogram.py:59",
              family["histogram"]["hist"], ["plane0"]),
        entry("sort_chunk_kv", "sort_chunk_kv", chunk_src,
              "libhpc_tpu/ops/sort_pallas_kv.py:87", kv_paths["chunk"],
              ["2^26/asc"]),
        entry("sort_merge_kv_level", "sort_merge_kv_level", merge_src,
              "libhpc_tpu/ops/sort_pallas_kv.py:143",
              kv_paths["merge"] - kv_paths["pair"], ["2^26/r2^15"]),
        entry("sort_merge_kv_pair", "sort_merge_kv_pair", merge_src,
              "libhpc_tpu/ops/sort_pallas_kv.py:143", kv_paths["pair"],
              ["2^26+2^24/desc1"]),
        entry("scan_f32", "scan_f32", scan_src, "libhpc_tpu/ops/scan.py:52",
              family["scan"]["scan_f32"], ["500M"]),
        entry("scan_int", "scan_int", scan_src, "libhpc_tpu/ops/scan.py:106",
              family["scan"]["scan_int"], ["500M"]),
        entry("row_sum", "row_sum", "libhpc_tpu_torch/csrc/reduce.cu",
              "libhpc_tpu/ops/reduce.py:63", family["reduce"]["row_sum"],
              ["8192^2"]),
        entry("transpose", "transpose", "libhpc_tpu_torch/csrc/transpose.cu",
              "libhpc_tpu/ops/transpose.py:26",
              family["transpose"]["transpose"]
              + family["matmul"]["transpose"], ["8192^2"]),
        entry("matmul", "matmul", mm_src, "libhpc_tpu/ops/matmul.py:23",
              family["matmul"]["matmul"], ["8192^2"]),
        entry("matmul_bf16", "matmul_bf16", mm_src,
              "libhpc_tpu/ops/matmul.py:23", family["matmul"]["matmul_bf16"],
              ["8192^2"]),
        entry("matmul_f16", "matmul_f16", mm_src,
              "libhpc_tpu/ops/matmul.py:23", family["matmul"]["matmul_f16"],
              ["8192^2"]),
        entry("blur", "blur2d", "libhpc_tpu_torch/csrc/blur2d.cu",
              "libhpc_tpu/ops/stencil.py:118", family["stencil"]["blur"],
              ["8192^2/r8"]),
        entry("overlap_sweep", "overlap_sweep",
              "libhpc_tpu_torch/csrc/overlap_chip.cu",
              "libhpc_tpu/bench/overlap_chip.py:37",
              family["overlap"]["sweep"], ["512MB/w0", "512MB/w64"]),
        entry("lane_shuffle", "lane_shuffle", ma_src,
              "libhpc_tpu/bench/microarch.py:93",
              family["microarch"]["lane_shuffle"], ["S1024/tiles1024"]),
        entry("dma_gather", "dma_gather", ma_src,
              "libhpc_tpu/bench/microarch.py:132",
              family["microarch"]["dma_gather"], ["2^17x4KB"]),
        entry("cmpex_roll", "cmpex_roll", ma_src,
              "libhpc_tpu/bench/microarch.py:189",
              family["microarch"]["cmpex_roll"], ["2^20"]),
        entry("cmpex_reshape", "cmpex_reshape", ma_src,
              "libhpc_tpu/bench/microarch.py:206",
              family["microarch"]["cmpex_reshape"], ["2^20"]),
    ]}


SYMGS_ARG = "--symgs"


def symgs_alone() -> int:
    """The symgs phase alone (``chip_smoke.py --symgs``), then its row of
    the kernels line: the whole run stops before that line where an
    earlier phase fails."""
    import torch

    from libhpc_tpu_torch.ops import _cuda_utils

    smi = nvidia_smi()
    print(smi, flush=True)
    _cuda_utils.kernel_lib()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "ptxas": _cuda_utils.ptxas_usage("symgs_dia.cu")})
    warm_up_card()
    kernel_times, family = {"symgs": {}}, {}
    symgs_phase(torch.device("cuda"), kernel_times, family)
    check_family_launches(family)
    emit({"kernels": [kernel_entry(
        kernel_times, "symgs", "symgs_dia",
        "libhpc_tpu_torch/csrc/symgs_dia.cu",
        "none: HPCG's SymGS (no Gauss-Seidel kernel in libhpc_tpu)",
        family["symgs"]["symgs"], ["256^3"])]})
    print(smi, flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from libhpc_tpu_torch.ops import _cuda_utils

    if sys.argv[1:] == [SORT_SPLIT_ARG]:
        emit(sort_split_profile())
        return 0
    if sys.argv[1:] == [DIST_SPLIT_ARG]:
        emit(dist_split_profile())
        return 0
    if sys.argv[1:] == [CORPUS_ARG]:
        print(json.dumps(corpus_child()), flush=True)
        return 0
    if sys.argv[1:] == [SYMGS_ARG]:
        return symgs_alone()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _cuda_utils.kernel_lib()
    build_s = time.perf_counter() - t0
    # cuobjdump disassembles the whole library (16 s on the H100 machine's
    # host): it runs beside the phases, and its count is checked after them
    sass = ThreadPoolExecutor(1)

    def count_hgmma():
        t0 = time.perf_counter()
        return _cuda_utils.count_sass("HGMMA"), time.perf_counter() - t0

    hgmma_lines = sass.submit(count_hgmma)
    # the native host library (g++) builds beside the phases too; the
    # runtime phase waits for it
    native = ThreadPoolExecutor(1)

    def build_native():
        from libhpc_tpu_torch.runtime import native as rt

        t0 = time.perf_counter()
        rt.build()
        return time.perf_counter() - t0

    native_build = native.submit(build_native)
    # registers and spills of the kernels redesigned last (K18's FMA
    # kernel, K13/K14's one-pass scan, the split search and merge-path
    # kernels of K9/K10/K12, the radix chunk sorts of K8/K11, K21b, the
    # SpMV kernel of K1-K3, every instance of K19), from the reports the
    # build kept
    t0 = time.perf_counter()
    ptxas = {fn: use for fn, use in _cuda_utils.ptxas_usage(
                 "matmul.cu", "scan.cu", "sort_merge.cu", "sort_chunk.cu",
                 "microarch.cu", "sbell_spmv.cu", "blur2d.cu").items()
             if any(k in fn for k in ("fma_kernel", "scan_kernel",
                                      MERGE_KERNEL, SPLIT_KERNEL,
                                      CHUNK_KERNEL, "dma_gather_kernel",
                                      "sbell_spmv_kernel", BLUR_KERNEL))}
    spilled = [fn for fn, use in ptxas.items()
               if CHUNK_KERNEL in fn and use.get("spill_stores", 0)
               or BLUR_KERNEL in fn and (use.get("spill_stores", 0)
                                         or use.get("spill_loads", 0))]
    ptxas_s = time.perf_counter() - t0
    if spilled:
        raise AssertionError(f"ptxas: these kernels spill: {spilled}")
    if not any(BLUR_KERNEL in fn for fn in ptxas):
        raise AssertionError("ptxas: no record of K19's kernel")
    dev = torch.device("cuda")
    warm_up_card()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "ptxas_s": ptxas_s,
          "library": str(_cuda_utils.library_path().name), "ptxas": ptxas})
    kernels = run(dev, native_build)
    native.shutdown()
    hgmma, sass_s = hgmma_lines.result()
    sass.shutdown()
    if hgmma == 0:
        raise AssertionError("the kernel library's SASS holds no HGMMA: "
                             "K18's half-width path runs no wgmma")
    emit({"phase": "sass", "hgmma_sass_lines": hgmma, "cuobjdump_s": sass_s})
    emit(kernels)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
