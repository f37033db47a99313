"""The readers of the program's own spans (program_spans.py) on a
hand-built trace with a known answer, where they must give nothing, the
CPU's traced run of the solve cell, and on the card the relations each
traced cell's line must keep between the new metrics and the old."""

import json
import subprocess
import sys

import pytest

from hpcbench import harness, program_spans, roofline, spec
from hpcbench.drive import Inputs, Window
from hpcbench.layers import Record, spmv_roofline_pct
from hpcbench.tests.conftest import ROOT
from hpcbench.trace import WINDOW, Trace

H100 = "NVIDIA H100 80GB HBM3"
NNZ, ROWS = 3_000_000, 1_000_000
SEED = 2**31 + 29
BENCH = spec.load_benchmark(ROOT)


def cells_reading(prefix):
    """(cell, metric) for each cell whose per-layer metrics list a metric
    named `prefix` or `prefix`.<suffix>."""
    return [(w["name"], m["name"]) for w in BENCH["workloads"]
            for m in spec.find_cell(BENCH, w["name"],
                                    ROOT / "hpcbench").per_layer
            if m["name"] == prefix or m["name"].startswith(prefix + ".")]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr)


def _op(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, tid=7, correlation=corr, stream=7)


def two_iterations(program=True):
    """A window of 200 us holding two CG iterations, as the program's spans
    and the device see them (times in us):

    - sync 5..15 after a dot (device 0..12); the next operation, the pad
      launched inside prepare, runs 20..22: an idle gap 12..20 (8 us)
      runs across the sync's end;
    - iteration 16..60: prepare 17..19, launch 24..30 (the kernel 26..46,
      20 us), an axpy 46..54;
    - sync 62..70; the next pad runs 75..77: idle 54..75 (21 us);
    - iteration 71..120: prepare 72..74, launch 78..84 (the kernel 81..111,
      30 us), an axpy 111..115;
    - a launch span past the window (205..208), whose kernel counts
      nowhere.

    `program` False leaves the program's spans out, as a program older
    than them does."""
    spans = [
        _x("user_annotation", program_spans.SYNC, 5, 10),
        _x("user_annotation", program_spans.ITERATION, 16, 44),
        _x("user_annotation", "libhpc.spmv.prepare", 17, 2),
        _x("user_annotation", program_spans.LAUNCH, 24, 6),
        _x("user_annotation", program_spans.SYNC, 62, 8),
        _x("user_annotation", program_spans.ITERATION, 71, 49),
        _x("user_annotation", "libhpc.spmv.prepare", 72, 2),
        _x("user_annotation", program_spans.LAUNCH, 78, 6),
        _x("user_annotation", program_spans.LAUNCH, 205, 3),
    ]
    return [
        _x("user_annotation", WINDOW, 0, 200),
        *(spans if program else []),
        _launch(1, 9), _launch(18, 1), _launch(25, 2), _launch(50, 3),
        _launch(73, 4), _launch(80, 5), _launch(112, 6), _launch(206, 7),
        _op("dot", 0, 12, 9), _op("pad", 20, 2, 1), _op("k4", 26, 20, 2),
        _op("axpy", 46, 8, 3), _op("pad", 75, 2, 4), _op("k4", 81, 30, 5),
        _op("axpy", 111, 4, 6), _op("k4", 209, 6, 7),
    ]


def _record(events, iterations=2):
    return Record(cell=None,
                  inputs=Inputs(matrix=None, shape=(ROWS, ROWS), nnz=NNZ),
                  window=Window(iterations=iterations), setup_s=0.0,
                  build_s=0.0, device_kind=H100, trace=Trace(events))


def test_sync_idle_is_the_gap_across_each_sync_end():
    rec = _record(two_iterations())
    assert program_spans.sync_idle_ms_per_iter(rec) == \
        pytest.approx((8 + 21) / 2 * 1e-3)


def test_host_time_is_the_iteration_spans():
    rec = _record(two_iterations())
    assert program_spans.host_ms_per_iter(rec) == \
        pytest.approx((44 + 49) / 2 * 1e-3)


def test_kernel_roofline_reads_the_launch_spans_alone():
    rec = _record(two_iterations())
    ops = program_spans.ops_launched_in(rec.trace, program_spans.LAUNCH)
    assert [op[2] for op in ops] == ["k4", "k4"]
    least = roofline.spmv_least_seconds(NNZ, ROWS, ROWS, H100)
    got = program_spans.spmv_kernel_roofline_pct(rec)
    assert got == pytest.approx(100 * least / 25e-6)
    # the same on the stream cell's reader and the solve cell's
    for name in ("spmv_kernel_roofline_pct.cg",
                 "spmv_kernel_roofline_pct.spmv"):
        path = ROOT / "hpcbench" / "metrics" / f"{name}.py"
        assert spec.load_file(path).read(rec) == got


def test_every_reader_gives_nothing_without_the_programs_spans():
    rec = _record(two_iterations(program=False))
    for name in ("sync_idle_ms_per_iter", "host_ms_per_iter",
                 "spmv_kernel_roofline_pct.cg",
                 "spmv_kernel_roofline_pct.spmv"):
        path = ROOT / "hpcbench" / "metrics" / f"{name}.py"
        assert spec.load_file(path).read(rec) is None, name


def test_an_unmatched_launch_gives_no_kernel_share():
    events = two_iterations()
    events.append(_x("kernel", "library", 56, 1, tid=7, correlation=99,
                     stream=7))
    rec = _record(events)
    assert rec.trace.unlaunched == 1
    assert program_spans.ops_launched_in(rec.trace,
                                         program_spans.LAUNCH) is None
    assert program_spans.spmv_kernel_roofline_pct(rec) is None
    # the host spans and the idle gaps need no launch
    assert program_spans.host_ms_per_iter(rec) == \
        pytest.approx((44 + 49) / 2 * 1e-3)


def test_readers_give_nothing_without_a_trace_or_iterations():
    rec = _record(two_iterations(), iterations=0)
    assert program_spans.sync_idle_ms_per_iter(rec) is None
    assert program_spans.host_ms_per_iter(rec) is None
    rec.trace = None
    assert program_spans.spmv_kernel_roofline_pct(rec) is None


@pytest.mark.parametrize("name,metric", cells_reading("host_ms_per_iter"))
def test_cpu_traced_run_prints_host_ms_per_iter(small_cell, name, metric):
    cell = small_cell(name)
    out = harness.run_cell(cell, SEED, 0.3, True, device="cpu")
    assert out["correct"]
    assert out["metrics"][metric]["value"] > 0
    # the CPU has no device trace: the device readers give nothing
    for m in cell.per_layer:
        if m["name"].startswith(("sync_idle_ms_per_iter",
                                 "spmv_kernel_roofline_pct")):
            assert m["name"] not in out["metrics"]


def _traced_line(cell):
    res = subprocess.run(
        [sys.executable, "hpcbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,metric",
                         cells_reading("spmv_kernel_roofline_pct"))
def test_traced_line_keeps_the_new_metrics_in_their_bounds(cuda_device,
                                                           cell, metric):
    out = _traced_line(cell)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    kernel = m[metric]
    suffix = metric[len("spmv_kernel_roofline_pct"):]
    # the kernel alone is part of the whole call, so it reads no lower
    assert 0 < kernel <= 100
    assert kernel >= m["spmv_roofline_pct" + suffix]
    c = spec.find_cell(BENCH, cell)
    if any(x["name"] == "sync_idle_ms_per_iter" for x in c.per_layer):
        iterations = out["attempted"] * c.traffic["iterations"]
        dev = out["device"]
        idle_ms = (dev["window_s"] - dev["busy_s"]) * 1e3
        assert 0 <= m["sync_idle_ms_per_iter"] <= idle_ms / iterations
        assert m["host_ms_per_iter"] > 0
        names = [n for n, _ in out["breakdown"]["idle_gaps"]]
        assert any(n.startswith("libhpc.") for n in names), names


def test_spmv_roofline_of_the_whole_call_is_no_higher_on_a_known_trace():
    # the relation the card test holds, on the hand-built trace: the
    # benchmark's matvec span holds the pad and the kernel of each call
    events = two_iterations()
    events += [_x("user_annotation", "hpcbench.matvec", 17, 13),
               _x("user_annotation", "hpcbench.matvec", 72, 12)]
    rec = _record(events)
    assert spmv_roofline_pct(rec) <= program_spans.spmv_kernel_roofline_pct(
        rec)


def test_idle_gap_across_a_sync_end_goes_to_the_sync():
    """One sync, then the benchmark's matvec span in the same idle gap:
    the gap's middle lies in the matvec span, but the host left the card
    idle at the sync, so the gap goes to the sync; a gap with no sync end
    in it keeps the rule of its middle."""
    events = [
        _x("user_annotation", WINDOW, 0, 100),
        _x("user_annotation", program_spans.SYNC, 5, 10),
        _x("user_annotation", "hpcbench.matvec", 18, 40),
        _launch(1, 1), _launch(20, 2), _launch(60, 3),
        _op("dot", 0, 12, 1), _op("k4", 50, 10, 2), _op("axpy", 70, 5, 3),
    ]
    gaps = dict(Trace(events).idle_gaps())
    # 12..50 holds the sync's end (15), its middle (31) the matvec span;
    # 60..70 and 75..100 have only the window's span at their middles
    assert gaps == {program_spans.SYNC: pytest.approx(38e-6),
                    WINDOW: pytest.approx(35e-6)}
    # on the two iterations, each gap that holds a sync end is the sync's
    assert dict(Trace(two_iterations()).idle_gaps())[program_spans.SYNC] \
        == pytest.approx((8 + 21) * 1e-6)
