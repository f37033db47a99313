"""The port's own trace ranges (``utils/profiling.annotate``): the ranges
the Krylov loops and the SpMV wrappers open while a profiler records, that
they open none while nothing records, and that tracing changes no result.
CPU only; imports no JAX."""

import json

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from torch.profiler import ProfilerActivity, profile

from libhpc_tpu_torch.ops import solver, spmv_dia, spmv_sbell
from libhpc_tpu_torch.ops.spmv_dia import DiaPallas
from libhpc_tpu_torch.sparse import DIA
from libhpc_tpu_torch.sparse.sbell import SBELL
from libhpc_tpu_torch.utils import profiling

# the names readers of the port's traces match
SYNC = "libhpc.solver.sync"
ITERATION = "libhpc.solver.iteration"
PREPARE = "libhpc.spmv.prepare"
LAUNCH = "libhpc.spmv.launch"
ITERS = 5


def _poisson(n=24):
    t = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    eye = sps.identity(n)
    return (sps.kron(eye, t) + sps.kron(t, eye)).astype(np.float32).tocsr()


def _dia_matvec():
    dp = DiaPallas.from_dia(DIA.from_scipy(_poisson(), device="cpu"),
                            T=256, device="cpu")
    return lambda v: spmv_dia.dia_spmv_pallas(dp, v)


def _sbell():
    return SBELL.from_scipy(_poisson(40), device="cpu")


def _b(n):
    g = torch.Generator().manual_seed(7)
    return torch.randn(n, generator=g, dtype=torch.float32)


SOLVERS = {
    "cg": lambda mv, b: solver.cg(mv, b, tol=0.0, max_iter=ITERS),
    "pcg_op": lambda mv, b: solver.pcg_op(mv, lambda r: 0.25 * r, b,
                                          tol=0.0, max_iter=ITERS),
    "bicgstab": lambda mv, b: solver.bicgstab(mv, b, tol=0.0,
                                              max_iter=ITERS),
}


def _traced(fn, tmp_path):
    """fn() under a CPU profile; its result and the trace's complete
    events, as the exported Chrome trace holds them."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    return out, events


def _spans(events, name):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("name") == name)


def _inside(t, spans):
    return any(s <= t <= e for s, e in spans)


def _counted(mv):
    calls = []

    def f(v):
        calls.append(1)
        return mv(v)
    return f, calls


def _check_prepare_then_launch(events, calls):
    prep, launch = _spans(events, PREPARE), _spans(events, LAUNCH)
    assert len(prep) == len(launch) == calls
    for i, ((p0, p1), (l0, l1)) in enumerate(zip(prep, launch)):
        assert p1 <= l0, "a launch range opens before its prepare range ends"
        if i + 1 < calls:
            assert l1 <= prep[i + 1][0]
    ours = [e for e in events if str(e.get("name", "")).startswith("libhpc.")]
    assert len({e["tid"] for e in ours}) == 1, "ranges on more than a thread"


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_solver_loop_opens_its_ranges(name, tmp_path):
    mv, calls = _counted(_dia_matvec())
    b = _b(24 * 24)
    (x, it, _), events = _traced(lambda: SOLVERS[name](mv, b), tmp_path)
    assert it == ITERS
    syncs = _spans(events, SYNC)
    iters = _spans(events, ITERATION)
    assert len(iters) == ITERS
    # each sync range holds the loop's one host sync, and nothing else
    tests = [float(e["ts"]) for e in events
             if e.get("name") == "aten::is_nonzero"]
    assert len(syncs) == len(tests) == ITERS
    assert all(_inside(t, syncs) for t in tests)
    for s0, s1 in syncs:
        assert not any(i0 < s1 and s0 < i1 for i0, i1 in iters)
    _check_prepare_then_launch(events, len(calls))
    # every matvec but the first residual's runs inside an iteration
    launch = _spans(events, LAUNCH)
    assert sum(_inside(s, iters) for s, _ in launch) == len(calls) - 1


def test_sbell_spmv_opens_its_ranges(tmp_path):
    sb = _sbell()
    xs = [_b(sb.shape[1]) * k for k in (1, 2, 3)]
    _, events = _traced(lambda: [spmv_sbell.sbell_spmv(sb, x) for x in xs],
                        tmp_path)
    _check_prepare_then_launch(events, len(xs))


def test_no_range_is_entered_while_nothing_records(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.annotate(SYNC) is profiling.annotate(LAUNCH)
    mv = _dia_matvec()
    b = _b(24 * 24)
    for run in SOLVERS.values():
        assert run(mv, b)[1] == ITERS
    sb = _sbell()
    x = _b(sb.shape[1])
    y = spmv_sbell.sbell_spmv(sb, x)
    x3 = spmv_sbell.x_to_panes(
        sb, torch.nn.functional.pad(x, (0, sb.n_panes * 1024 - x.numel())))
    y3 = spmv_sbell.sbell_spmv_panes(sb, x3)
    assert torch.equal(spmv_sbell.panes_to_x(sb, y3)[:sb.shape[0]], y)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_results_are_bit_identical_with_and_without_a_profiler(name,
                                                                tmp_path):
    mv = _dia_matvec()
    b = _b(24 * 24)
    plain = SOLVERS[name](mv, b)
    traced, _ = _traced(lambda: SOLVERS[name](mv, b), tmp_path)
    assert plain[1] == traced[1] == ITERS
    assert torch.equal(plain[0], traced[0])
    assert torch.equal(plain[2], traced[2])
    sb = _sbell()
    x = _b(sb.shape[1])
    y, _ = _traced(lambda: spmv_sbell.sbell_spmv(sb, x), tmp_path)
    assert torch.equal(spmv_sbell.sbell_spmv(sb, x), y)
