"""Whole runs of each cell on the CPU at its configuration's small size
(small/<config>.json), through the program's plain paths: the reference
agrees with the program, the control (the cell's lower precision in the
program's place) comes out not correct, and so does each fault planted
underneath the timed path. Every test here takes each cell of
BENCHMARK.json, so a cell added as files alone is held to them all."""

import json
import subprocess
import sys

import pytest
import torch

from hpcbench import drive, harness, spec
from hpcbench.tests.conftest import ROOT

BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 11


def _run(cell, **kw):
    return harness.run_cell(cell, SEED, 0.3, False, device="cpu", **kw)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_programs_plain_path(small_cell, name):
    cell = small_cell(name)
    inp = spec.config_module(cell).make_inputs(cell.config, 5)
    prog = spec.config_module(cell).build(inp, cell.config, "cpu")
    ref = spec.reference_module(cell).operator(inp, torch.float64, "cpu")
    x = torch.randn(inp.shape[1], dtype=torch.float32)
    want = ref(x.double())
    got = prog.matvec(x).double()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6


@pytest.mark.parametrize("name", CELLS)
def test_program_run_is_correct(small_cell, name):
    out = _run(small_cell(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in small_cell(name).end_to_end}
    assert set(out["metrics"]) == names and "setup_s" in names


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(small_cell, name):
    out = _run(small_cell(name), variant="control")
    assert not out["correct"], out["checks"]


def _unchanged(cell):
    # a step that returns its state unchanged: the matvec hands back x
    return lambda p: drive.Program(lambda v: v.clone(), p.solver)


def _half(cell):
    # half of the rows left out
    def wrap(p):
        def mv(v):
            y = p.matvec(v).clone()
            y[y.numel() // 2:] = 0
            return y
        return drive.Program(mv, p.solver)
    return wrap


def _altered(cell):
    # the answer altered by a hundredth, at its largest entry, where it is
    # made
    def bump(t):
        t = t.clone()
        k = int(t.abs().argmax())
        t[k] *= 1.01
        return t

    def wrap(p):
        if cell.traffic["kind"] == "stream":
            return drive.Program(lambda v: bump(p.matvec(v)), p.solver)
        solve = spec.kind_module(cell).solver_of(cell.traffic, p)

        def s(matvec, b, **kw):
            x, it, r = solve(matvec, b, **kw)
            return bump(x), it, r
        return drive.Program(p.matvec, s)
    return wrap


def _stops_early(cell):
    # a solve that stops before the iterations the mix asks for
    def wrap(p):
        solve = spec.kind_module(cell).solver_of(cell.traffic, p)

        def s(matvec, b, tol=0.0, max_iter=50):
            return solve(matvec, b, tol=tol, max_iter=max_iter - 1)
        return drive.Program(p.matvec, s)
    return wrap


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered,
          "stops_early": _stops_early}


def _kind(name):
    return spec.find_cell(BENCH, name, ROOT / "hpcbench").traffic["kind"]


# a stream call has no iterations to stop early
CASES = [(name, fault) for name in CELLS for fault in sorted(FAULTS)
         if not (fault == "stops_early" and _kind(name) == "stream")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(small_cell, name, fault):
    cell = small_cell(name)
    out = _run(cell, wrap=FAULTS[fault](cell))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_window(small_cell, name):
    cell = small_cell(name)
    out = harness.run_cell(cell, SEED, 0.3, True, device="cpu")
    assert out["correct"]
    phases = out["setup_phases_s"]
    assert list(phases) == ["imports", "inputs", "payloads", "build",
                            "warm_up"]
    marked = harness.run_cell(cell, SEED, 0.1, False, device="cpu",
                              marks=[("imports", 0.0), ("cuda_init", 0.0)])
    assert list(marked["setup_phases_s"]) == [
        "imports", "cuda_init", "harness", "inputs", "payloads", "build",
        "warm_up"]
    if any(m["name"] == "build_s" for m in cell.per_layer):
        assert out["metrics"]["build_s"]["value"] == phases["build"]
    # the CPU has no device trace: the device readers return nothing
    device = {m["name"] for m in cell.per_layer
              if m["source"] == "device_trace"}
    assert not device & set(out["metrics"])
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_without_a_card_prints_no_result(tmp_path):
    res = subprocess.run(
        [sys.executable, str(ROOT / "hpcbench" / "run.py"), "--workload",
         "hpcg_27pt_256.cg50", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_harness_loads_neither_jax_nor_the_jax_package(small_cell):
    """Every module a run loads, in a fresh process: no top-level name,
    compared whole, is jax, jaxlib, flax or libhpc_tpu."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from hpcbench import harness, spec, calibrate\n"
        "from hpcbench.tests.conftest import shrink\n"
        "b = spec.load_benchmark(%r)\n"
        "for w in b['workloads']:\n"
        "    c = shrink(spec.find_cell(b, w['name']))\n"
        "    harness.run_cell(c, 3, 0.1, True, device='cpu')\n"
        "    for m in b['end_to_end'] + b['per_layer']:\n"
        "        spec.metric_reader(c, m['name'])\n"
        "print(json.dumps(harness.banned_modules()))\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n"
    ) % (str(ROOT), str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    banned, tops = (json.loads(line) for line in
                    res.stdout.strip().splitlines()[-2:])
    assert banned == []
    assert "libhpc_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "libhpc_tpu"} & set(tops)
