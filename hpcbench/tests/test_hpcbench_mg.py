"""The cell hpcg_mg_256.mgpcg50 on the CPU at its small size: faults
planted in the program's V-cycle, under the timed path, come out not
correct by ``pc_err`` (where ``x_err`` alone would pass some of them); the
judge takes p0 from a solver that applies A to x0 = 0 first and from one
that does not; and the byte model and the readers of the V-cycle's spans
on a hand-built trace, and those of the solver loop and of the fine
level's K4 there."""

import pytest
import torch

from hpcbench import drive, harness, roofline, roofline_mg, spec
from hpcbench.drive import Inputs, Window
from hpcbench.layers import Record
from hpcbench.tests.test_hpcbench_program_spans import H100, _launch, _op, _x
from hpcbench.trace import WINDOW, Trace
from libhpc_tpu_torch.ops import multigrid_dia, symgs_dia

CELL = "hpcg_mg_256.mgpcg50"
SEED = 2**33 + 17


def _run(small_cell, **kw):
    return harness.run_cell(small_cell(CELL), SEED, 0.3, False, device="cpu",
                            **kw)


def _skip_coarse_correction(mp):
    mp.setattr(multigrid_dia, "prolong", lambda *a: None)


def _drop_backward_sweep(mp):
    mp.setattr(symgs_dia, "BACKWARD", ())


def _leave_out_colour_5(mp):
    for name in ("FORWARD", "BACKWARD"):
        mp.setattr(symgs_dia, name,
                   tuple(c for c in getattr(symgs_dia, name) if c != 5))


FAULTS = {"coarse_correction_skipped": _skip_coarse_correction,
          "backward_sweep_dropped": _drop_backward_sweep,
          "one_colour_left_out": _leave_out_colour_5}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_vcycle_fault_fails_pc_err(small_cell, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = _run(small_cell)
    checks = out["checks"]
    assert not out["correct"], checks
    assert checks["pc_err"]["value"] > checks["pc_err"]["limit"], checks
    assert checks["short"]["value"] == 0


def test_x_err_alone_would_pass_a_vcycle_fault(small_cell):
    """At tol 0 a float32 solve reaches its rounding floor within 50
    iterations under a weakened V-cycle too: x_err passes at least one of
    the planted faults, which pc_err catches."""
    passed = {}
    for fault, plant in FAULTS.items():
        with pytest.MonkeyPatch.context() as mp:
            plant(mp)
            x_err = _run(small_cell)["checks"]["x_err"]
        passed[fault] = x_err["value"] <= x_err["limit"]
    assert any(passed.values()), passed


def test_judge_takes_p0_from_a_solver_that_skips_A_x0(small_cell):
    """The reference's PCG in float32 in the solver's place applies A to
    p0 first, where pcg_op applies it to x0 = 0 first: both are correct."""
    cell = small_cell(CELL)
    inp = spec.config_module(cell).make_inputs(cell.config, SEED)
    ref = spec.reference_module(cell)

    def wrap(p):
        return drive.Program(p.matvec,
                             ref.solver(inp, torch.float32, "cpu"))

    out = _run(small_cell, wrap=wrap)
    assert out["correct"], out["checks"]
    assert out["checks"]["pc_err"]["value"] < 1e-5


def test_program_counts_vcycles(small_cell):
    out = _run(small_cell)
    assert out["correct"], out["checks"]
    # one V-cycle before the loop and one an iteration, warm-up excluded
    iters = out["attempted"] * small_cell(CELL).traffic["iterations"]
    assert out["counters"]["MG_VCYCLES"] == iters + out["attempted"]
    # kernels launch only on the card
    assert out["counters"]["SYMGS_LAUNCHES"] == 0


def test_smoother_bytes_and_least_time():
    assert roofline_mg.sweep_bytes(10) == 30 * 10 * 4
    assert roofline_mg.sweeps(4) == [4, 4, 4, 2]
    grids = [(256 >> k,) * 3 for k in range(4)]
    rows = [g[0] ** 3 for g in grids]
    want = sum(n * 120 * m for n, m in zip([4, 4, 4, 2], rows)) / 3.35e12
    assert roofline_mg.smoother_least_seconds(grids, H100) == \
        pytest.approx(want)
    assert roofline_mg.smoother_least_seconds(grids, "cpu") is None


def _mg_trace():
    """A 100 us window holding two V-cycles (10..40, 50..80), each with
    one smooth span; kernels: smooth 12..22 and 52..64, a residual 25..33
    and 66..70 inside the V-cycles, a matvec 85..95 outside them."""
    vcycle, smooth = "libhpc.mg.vcycle", "libhpc.mg.smooth"
    return Trace([
        _x("user_annotation", WINDOW, 0, 100),
        _x("user_annotation", vcycle, 10, 30),
        _x("user_annotation", smooth, 11, 5),
        _x("user_annotation", vcycle, 50, 30),
        _x("user_annotation", smooth, 51, 5),
        _launch(12, 1), _launch(20, 2), _launch(52, 3), _launch(60, 4),
        _launch(84, 5),
        _op("symgs", 12, 10, 1), _op("k4", 25, 8, 2),
        _op("symgs", 52, 12, 3), _op("k4", 66, 4, 4),
        _op("k4", 85, 10, 5),
    ])


def _record(trace, grids):
    return Record(cell=None,
                  inputs=Inputs(matrix=None, shape=(8, 8), nnz=1,
                                sizes={"grids": grids}),
                  window=Window(iterations=1), setup_s=0.0, build_s=0.0,
                  device_kind=H100, trace=trace)


def test_vcycle_readers_on_a_known_trace(small_cell):
    cell = small_cell(CELL)
    grids = [[16, 16, 16], [8, 8, 8]]
    rec = _record(_mg_trace(), grids)
    per_vcycle = spec.metric_reader(cell, "mg_ms_per_vcycle")
    roof = spec.metric_reader(cell, "symgs_roofline_pct")
    assert per_vcycle(rec) == pytest.approx((10 + 8 + 12 + 4) / 2 * 1e-3)
    least = roofline_mg.smoother_least_seconds(grids, H100)
    assert roof(rec) == pytest.approx(100 * least * 2 / 22e-6)
    # nothing to read: no trace, a program without the spans, no grids
    rec.trace = None
    assert per_vcycle(rec) is None and roof(rec) is None
    bare = Trace([_x("user_annotation", WINDOW, 0, 100), _launch(1, 1),
                  _op("k4", 2, 5, 1)])
    assert per_vcycle(_record(bare, grids)) is None
    assert roof(_record(bare, grids)) is None
    assert roof(_record(_mg_trace(), None)) is None


def _pcg_trace(vcycle=True):
    """A 200 us window holding one PCG iteration (10..100): a matvec span
    12..30 with its pad (launched at 13) and the fine K4 (launched inside
    the launch span 14..20); an axpy launched at 32; a V-cycle 40..80 with
    a sweep (launched at 42) and a coarse K4 (inside the launch span
    50..55); a dot launched at 85."""
    spans = [_x("user_annotation", WINDOW, 0, 200),
             _x("user_annotation", "libhpc.solver.iteration", 10, 90),
             _x("user_annotation", "hpcbench.matvec", 12, 18),
             _x("user_annotation", "libhpc.spmv.launch", 14, 6),
             _x("user_annotation", "libhpc.spmv.launch", 50, 5)]
    if vcycle:
        spans.append(_x("user_annotation", "libhpc.mg.vcycle", 40, 40))
    return Trace(spans + [
        _launch(13, 1), _launch(15, 2), _launch(32, 3), _launch(42, 4),
        _launch(52, 5), _launch(85, 6),
        _op("pad", 16, 2, 1), _op("k4", 20, 10, 2), _op("axpy", 33, 5, 3),
        _op("symgs", 45, 20, 4), _op("k4", 66, 4, 5), _op("dot", 86, 3, 6),
    ])


def test_solver_loop_and_fine_kernel_readers_on_a_known_trace(small_cell):
    cell = small_cell(CELL)
    vector = spec.metric_reader(cell, "vector_ms_per_iter.pcg")
    kernel = spec.metric_reader(cell, "fine_spmv_kernel_roofline_pct")
    rec = _record(_pcg_trace(), None)
    # the axpy and the dot: the matvec's pad and kernel and the V-cycle's
    # operations are other layers'
    assert vector(rec) == pytest.approx((5 + 3) * 1e-3)
    # the fine K4 alone: the coarse K4 runs inside a launch span too, but
    # outside every matvec span
    least = roofline.spmv_least_seconds(1, 8, 8, H100)
    assert kernel(rec) == pytest.approx(100 * least / 10e-6)
    # a program without the V-cycle's spans would count it as vector work
    assert vector(_record(_pcg_trace(vcycle=False), None)) is None
    rec.trace = None
    assert vector(rec) is None and kernel(rec) is None
    bare = Trace([_x("user_annotation", WINDOW, 0, 100), _launch(1, 1),
                  _op("k4", 2, 5, 1)])
    assert vector(_record(bare, None)) is None
    assert kernel(_record(bare, None)) is None
