"""Micro-architecture truth suite: committed, reproducible, JSON-emitting.

Port of ``libhpc_tpu/bench/microarch.py``, the re-expression of libHPC's
four GPU testsuites (lib/gpu/{stall_lg,stall_short,mio_throttle,
transfer_overlap}_testsuite): executables that measure the hardware facts
the kernels are designed around. On the card:

  gather_row_width  row-gather rate vs row width (torch indexing)
  scatter_modes     scatter-add with duplicate keys (``index_add_``),
                    permutation scatter (``index_put_``) and gather, and
                    the port's ``segment_sum``
  lane_shuffle      128-lane dynamic gather within a table row
                    (take_along_axis on axis 1), the SBELL x-gather
                    primitive: K21a ``lane_shuffle``
  dma_gather        random 4 KB row gathers staged through a ring in
                    shared memory by bulk copies (TMA): K21b ``dma_gather``
  roll_vs_reshape   one compare-exchange pass by a one-lane rotate (K21c
                    ``cmpex_roll``) vs by pairing adjacent lanes (K21d
                    ``cmpex_reshape``), the layout question behind the
                    merge sort

The kernels are in ``csrc/microarch.cu``; each wrapper has a plain version
(``*_torch``). The two compare-exchange passes do not compute the same
function, on the TPU as here: the roll pairs even lane 2k with lane 2k - 1
(lane 0 with lane 127), the reshape pairs (2k, 2k + 1); they agree on the
odd lanes only.

The TPU sizing is layout, not semantics. ``dma_gather`` takes the
reference's R (rows a gather) and G (gathers in flight): a block keeps a
ring of ``stages`` stages of ``stage_rows`` rows (``gather_plan``: whole
gathers a stage where they fit, never more rows than G gathers), since the
reference's G R rows (1 MB at the default G = 256) do not fit a block's
shared memory; the record keeps G as ``in_flight`` and adds the ring's
``stages``, ``stage_rows`` and ``rows_in_flight_per_block``.

Every timing uses the harness's delta method. The reference multiplies
each gather index by ``_live_flag(v)``, a runtime 1, so that XLA cannot
hoist the gather out of its timing loop; eager PyTorch runs every call it
is given, so the flag is dropped.

Dispatch: CPU tensors take the plain versions; CUDA tensors launch the
kernels or raise. Every bench runs on ``device`` (default ``"cuda"``).
``LANE_SHUFFLE_LAUNCHES``, ``DMA_GATHER_LAUNCHES``, ``CMPEX_ROLL_LAUNCHES``
and ``CMPEX_RESHAPE_LAUNCHES`` count kernel launches.

Run:  python -m libhpc_tpu_torch.bench.microarch [name ...]
Emits one JSON line per measurement.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from libhpc_tpu_torch.bench.harness import time_iterated
from libhpc_tpu_torch.ops import reduce
from libhpc_tpu_torch.ops._cuda_utils import (as_tensor, cdiv, check_launch,
                                              check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)

LANE = 128
# K21b's ring (csrc/microarch.cu): stages a block cycles through, and the
# rows of 512 bytes a stage holds at most
DMA_STAGES = 4
STAGE_ROWS = 32
DMA_MAX_STAGES = 8
DMA_MAX_PIECES = 32   # copies a stage: one a lane of the block's warp
DMA_RING_BYTES = 224 << 10   # of the 227 KB of shared memory a block may use

LANE_SHUFFLE_LAUNCHES = 0
DMA_GATHER_LAUNCHES = 0
CMPEX_ROLL_LAUNCHES = 0
CMPEX_RESHAPE_LAUNCHES = 0


def _emit(name: str, **fields):
    d = {"bench": name}
    d.update({k: (round(v, 4) if isinstance(v, float) else v)
              for k, v in fields.items()})
    print(json.dumps(d), flush=True)


def _launch(name: str, tensors, ints, dev) -> None:
    fn = kernel_fn(name, len(tensors), len(ints))
    with torch.cuda.device(dev):
        rc = fn(*(t.data_ptr() for t in tensors), *ints, current_stream_ptr())
    check_launch(rc, name)


def _check_aligned(name: str, *tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a tensor is not 16-byte aligned")


# ---------------------------------------------------------------------------
# K21a: 128-lane dynamic gather within a table row
# ---------------------------------------------------------------------------


def lane_shuffle_torch(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K21a: out[g S + r, l] = tab[r, idx[g S + r, l]]."""
    s = tab.shape[0]
    n_tiles = idx.shape[0] // s
    return torch.gather(tab.expand(n_tiles, s, LANE), 2,
                        idx.reshape(n_tiles, s, LANE).long()
                        ).reshape(n_tiles * s, LANE)


def lane_shuffle(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K21a: tab (S, 128) float32, idx (n_tiles S, 128) int32 lanes in
    [0, 128) -> (n_tiles S, 128) float32. The kernel reads lane idx & 127,
    so an index outside the range never leaves its row."""
    global LANE_SHUFFLE_LAUNCHES
    if tab.ndim != 2 or idx.ndim != 2 or tab.shape[1] != LANE \
            or idx.shape[1] != LANE or tab.shape[0] == 0 \
            or idx.shape[0] % tab.shape[0]:
        raise ValueError(f"lane_shuffle: tab (S, {LANE}) and idx "
                         f"(n_tiles S, {LANE}), got {tuple(tab.shape)} and "
                         f"{tuple(idx.shape)}")
    dev = kernel_device(tab, idx)
    if dev.type == "cpu":
        return lane_shuffle_torch(tab, idx)
    s, rows = tab.shape[0], idx.shape[0]
    check_tensor(tab, "tab", dev, (torch.float32,), (s, LANE))
    check_tensor(idx, "idx", dev, (torch.int32,), (rows, LANE))
    _check_aligned("lane_shuffle", tab, idx)
    if rows >= 1 << 31:
        raise ValueError(f"lane_shuffle: {rows} rows; the kernel takes "
                         "< 2^31")
    out = torch.empty((rows, LANE), dtype=torch.float32, device=dev)
    if rows:
        _launch("lane_shuffle_f32", (tab, idx, out), (s, rows // s), dev)
        LANE_SHUFFLE_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# K21b: random (R, 128) row gathers
# ---------------------------------------------------------------------------


def dma_gather_torch(idx: torch.Tensor, table: torch.Tensor,
                     R: int) -> torch.Tensor:
    """Plain version of K21b: out[k R + q] = table[idx[k] R + q], q < R."""
    n_table = table.shape[0] // R
    return table.reshape(n_table, R * LANE).index_select(
        0, idx.long()).reshape(-1, LANE)


def gather_plan(R: int, G: int, stages: int = DMA_STAGES,
                stage_rows: int = STAGE_ROWS) -> tuple[int, int]:
    """(stages, rows a stage) of K21b's ring for gathers of R rows with G
    in flight: a stage holds whole gathers where R rows fit in stage_rows
    (at most DMA_MAX_PIECES of them), else stage_rows rows of one gather;
    the ring holds no more rows than G gathers and no more than
    DMA_RING_BYTES, and at least two stages (one loading while one is
    stored)."""
    if R < 1 or G < 1 or stage_rows < 1 or not 2 <= stages <= DMA_MAX_STAGES:
        raise ValueError(f"gather_plan: R = {R}, G = {G}, {stages} stages "
                         f"of {stage_rows} rows")
    if R <= stage_rows:
        rows = R * min(stage_rows // R, DMA_MAX_PIECES, G)
    else:
        rows = stage_rows
    fit = DMA_RING_BYTES // (rows * LANE * 4)
    if fit < 2:
        raise ValueError(f"gather_plan: two stages of {rows} rows pass "
                         f"{DMA_RING_BYTES} bytes of shared memory")
    return max(2, min(stages, cdiv(G * R, rows), fit)), rows


def dma_gather(idx: torch.Tensor, table: torch.Tensor, R: int = 8,
               G: int = 256, *, stages: int = DMA_STAGES,
               stage_rows: int = STAGE_ROWS) -> torch.Tensor:
    """K21b: idx (n_gather,) int32 in [0, n_table), table (n_table R, 128)
    float32 -> (n_gather R, 128) float32. G is the reference's gathers in
    flight; a block here keeps the ring of ``gather_plan(R, G, stages,
    stage_rows)`` in flight. The kernel clamps indices into
    [0, n_table)."""
    global DMA_GATHER_LAUNCHES
    if idx.ndim != 1 or table.ndim != 2 or table.shape[1] != LANE \
            or R < 1 or G < 1 or table.shape[0] % R:
        raise ValueError(f"dma_gather: idx (n_gather,), table (n_table R, "
                         f"{LANE}) with R, G >= 1, got {tuple(idx.shape)}, "
                         f"{tuple(table.shape)}, R = {R}, G = {G}")
    dev = kernel_device(idx, table)
    if dev.type == "cpu":
        return dma_gather_torch(idx, table, R)
    n_gather, n_table = idx.shape[0], table.shape[0] // R
    check_tensor(idx, "idx", dev, (torch.int32,), (n_gather,))
    check_tensor(table, "table", dev, (torch.float32,), (n_table * R, LANE))
    _check_aligned("dma_gather", table)
    if n_gather * R >= 1 << 31 or n_table * R >= 1 << 31:
        raise ValueError("dma_gather: the kernel takes < 2^31 rows")
    if n_gather and not n_table:
        raise ValueError("dma_gather: indices into an empty table")
    n_stages, rows = gather_plan(R, G, stages, stage_rows)
    out = torch.empty((n_gather * R, LANE), dtype=torch.float32, device=dev)
    if n_gather:
        _launch("dma_gather_f32", (idx, table, out),
                (n_table, n_gather, R, rows, n_stages), dev)
        DMA_GATHER_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# K21c, K21d: one compare-exchange pass
# ---------------------------------------------------------------------------


def _even_lanes(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], device=x.device) % 2 == 0


def cmpex_roll_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K21c: y = roll(x, 1) on the lanes, min(x, y) on
    even lanes and max(x, y) on odd ones."""
    y = torch.roll(x, 1, dims=1)
    return torch.where(_even_lanes(x), torch.minimum(x, y),
                       torch.maximum(x, y))


def cmpex_reshape_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K21d: lanes paired (2k, 2k + 1), min then max."""
    p = x.reshape(x.shape[0], LANE // 2, 2)
    a, b = p[:, :, 0], p[:, :, 1]
    return torch.stack([torch.minimum(a, b), torch.maximum(a, b)],
                       dim=2).reshape(x.shape[0], LANE)


def _cmpex(x: torch.Tensor, name: str, plain):
    """K21c or K21d on x; returns (out, kernel launches made)."""
    if x.ndim != 2 or x.shape[1] != LANE:
        raise ValueError(f"{name}: (rows, {LANE}) input, got shape "
                         f"{tuple(x.shape)}")
    dev = kernel_device(x)
    if dev.type == "cpu":
        return plain(x), 0
    check_tensor(x, "x", dev, (torch.float32,), tuple(x.shape))
    _check_aligned(name, x)
    if x.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: the kernel takes < 2^31 rows")
    out = torch.empty_like(x)
    if not x.shape[0]:
        return out, 0
    _launch(f"{name}_f32", (x, out), (x.shape[0],), dev)
    return out, 1


def cmpex_roll(x: torch.Tensor) -> torch.Tensor:
    """K21c: (rows, 128) float32, the roll pairing (NaN-free input)."""
    global CMPEX_ROLL_LAUNCHES
    out, n = _cmpex(x, "cmpex_roll", cmpex_roll_torch)
    CMPEX_ROLL_LAUNCHES += n
    return out


def cmpex_reshape(x: torch.Tensor) -> torch.Tensor:
    """K21d: (rows, 128) float32, the adjacent pairing (NaN-free input)."""
    global CMPEX_RESHAPE_LAUNCHES
    out, n = _cmpex(x, "cmpex_reshape", cmpex_reshape_torch)
    CMPEX_RESHAPE_LAUNCHES += n
    return out


# ---------------------------------------------------------------------------
# the benches
# ---------------------------------------------------------------------------


def bench_gather_row_width(n_rows: int = 1 << 17, m: int = 1 << 17, *,
                           device="cuda"):
    """Row-gather rate vs row width b (PERF_NOTES: per-ROW cost)."""
    rng = np.random.default_rng(0)
    idx = as_tensor(rng.integers(0, n_rows, m, dtype=np.int32),
                    device).long()
    for b in (1, 8, 16, 128):
        tab = as_tensor(rng.random((n_rows, b), np.float32), device)

        def step(v, tab=tab):
            return v + tab[idx].sum(dim=1)

        per = time_iterated(step, torch.zeros(m, device=device), iters=8,
                            iters_small=1)
        _emit("gather_row_width", b=b, g_rows_per_s=m / per / 1e9,
              gb_per_s=m * b * 4 / per / 1e9)


def bench_scatter_modes(n: int = 1 << 20, *, device="cuda"):
    rng = np.random.default_rng(1)
    dup = as_tensor(rng.integers(0, n // 4, n, dtype=np.int32),
                    device).long()
    perm = as_tensor(rng.permutation(n).astype(np.int32), device).long()
    modes = {
        "scatter_add_dup": lambda v: torch.zeros_like(v).index_add_(0, dup,
                                                                    v),
        "scatter_perm": lambda v: torch.zeros_like(v).index_put_((perm,), v),
        "gather_perm": lambda v: v[perm],
        "segment_sum": lambda v: reduce.segment_sum(v, dup, n),
    }
    for name, fn in modes.items():
        per = time_iterated(fn, torch.ones(n, device=device), iters=8,
                            iters_small=1)
        _emit("scatter_modes", mode=name, g_writes_per_s=n / per / 1e9)


def bench_lane_shuffle(S: int = 1024, n_tiles: int = 16, *, device="cuda"):
    """128-lane dynamic shuffle rate within a table row (the SBELL
    x-gather)."""
    rng = np.random.default_rng(2)
    tab = as_tensor(rng.random((S, LANE), np.float32), device)
    idx = as_tensor(rng.integers(0, LANE, (n_tiles * S, LANE), np.int32),
                    device)

    def step(v):
        return v + lane_shuffle(tab, idx)[:S]

    per = time_iterated(step, torch.zeros((S, LANE), device=device), iters=8,
                        iters_small=1)
    n = n_tiles * S * LANE
    _emit("lane_shuffle", g_gathers_per_s=n / per / 1e9, table_rows=S)


def bench_dma_gather(n_table: int = 1 << 12, n_gather: int = 1 << 14,
                     R: int = 8, G: int = 256, *, device="cuda"):
    """Random (R, 128)-row gather rate, staged by bulk copies."""
    rng = np.random.default_rng(3)
    table = as_tensor(rng.random((n_table * R, LANE), np.float32), device)
    idx = as_tensor(rng.integers(0, n_table, n_gather, dtype=np.int32),
                    device)

    def step(v):
        return v + dma_gather(idx, table, R, G)[:R]

    per = time_iterated(step, torch.zeros((R, LANE), device=device), iters=8,
                        iters_small=1)
    stages, rows = gather_plan(R, G)
    _emit("dma_gather", g_descriptors_per_s=n_gather / per / 1e9,
          gb_per_s=n_gather * R * LANE * 4 / per / 1e9, rows_per_dma=R,
          in_flight=G, stages=stages, stage_rows=rows,
          rows_in_flight_per_block=stages * rows)


def bench_roll_vs_reshape(rows: int = 2048, *, device="cuda"):
    """One compare-exchange pass, roll-based vs reshape pairing: the
    layout decision behind the merge-path sort (PERF_NOTES)."""
    rng = np.random.default_rng(4)
    x0 = as_tensor(rng.random((rows, LANE), np.float32), device)
    for name, f in (("roll", cmpex_roll), ("reshape", cmpex_reshape)):
        per = time_iterated(f, x0, iters=16, iters_small=2)
        _emit("roll_vs_reshape", variant=name,
              g_elems_per_s=rows * LANE / per / 1e9)


ALL = {
    "gather_row_width": bench_gather_row_width,
    "scatter_modes": bench_scatter_modes,
    "lane_shuffle": bench_lane_shuffle,
    "dma_gather": bench_dma_gather,
    "roll_vs_reshape": bench_roll_vs_reshape,
}


def main(argv):
    names = argv or list(ALL)
    for n in names:
        try:
            ALL[n]()
        except Exception as e:  # noqa: BLE001
            print(json.dumps({"bench": n,
                              "error": f"{type(e).__name__}: {e}"[:200]}),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
