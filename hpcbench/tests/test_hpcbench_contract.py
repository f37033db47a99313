"""BENCHMARK.json against the benchmark's contract, the harness's
discovery of a cell that comes as files alone, and a run in a directory
that holds only the benchmark."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

from hpcbench import harness, spec
from hpcbench.spec import NAME_RE, UNIT_RE
from hpcbench.tests.conftest import ROOT, shrink

BENCH = spec.load_benchmark(ROOT)
LINE_MAX = 200


def _line(text):
    return 1 <= len(text) <= LINE_MAX and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hpcbench"]
    assert BENCH["command"] == ["python3", "hpcbench/run.py"]
    assert all(_line(w) for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names:
        assert NAME_RE.match(n), n
    for m in metrics:
        assert UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen)), group
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("hpcbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        for k in c["reduced"]:
            assert not (k.endswith("_dim") or k.endswith("_rank")), k
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        cell = spec.find_cell(BENCH, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            # the end-to-end metric it moves is reported in that cell
            assert m["moves"] in names, (w["name"], m["name"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_layer_metric_of_every_cell_names_its_cells():
    """A per-layer metric that moves an end-to-end metric every cell
    reports (setup_s) lists the cells it was set for: without the list, a
    cell added later would take it on unasked."""
    every = {m["name"] for m in BENCH["end_to_end"] if "workloads" not in m}
    for m in BENCH["per_layer"]:
        if m["moves"] in every:
            assert m.get("workloads"), m["name"]


def test_every_file_the_harness_looks_for_is_there():
    for w in BENCH["workloads"]:
        cell = spec.find_cell(BENCH, w["name"])
        # the CPU tests' size replaces keys the configuration has
        full = dict(cell.config)
        assert set(shrink(cell).config) == set(full)
        assert spec.config_module(cell).make_inputs
        assert spec.reference_module(cell)
        kind = spec.kind_module(cell)
        assert kind.make_payloads and kind.run and kind.judge
        assert cell.limits["limits"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(cell, m["name"]))


DUMMY_CONFIG = '''
import numpy as np
import scipy.sparse as sps
from hpcbench.drive import Inputs, Program


def make_inputs(cfg, seed):
    n = cfg["rows"]
    A = sps.diags([-1.0, cfg["diagonal"], -1.0], [-1, 0, 1], shape=(n, n),
                  dtype=np.float32).tocsr()
    return Inputs(matrix=A, shape=A.shape, nnz=int(A.nnz),
                  sizes={"diagonal": cfg["diagonal"]})


def build(inputs, cfg, device, variant="program"):
    if variant == "control":
        import torch
        from hpcbench.reference import cg, tridiag

        return Program(matvec=tridiag.operator(inputs, torch.bfloat16, device),
                       solver=cg.solver(torch.bfloat16))
    from libhpc_tpu_torch.sparse.auto import auto_format
    container, matvec = auto_format(inputs.matrix, device=device)
    return Program(matvec=lambda v: matvec(container, v))
'''

DUMMY_REFERENCE = '''
import torch


def operator(inputs, dtype, device):
    d = inputs.sizes["diagonal"]

    def op(v):
        v = v.to(device=device, dtype=dtype)
        y = d * v
        y[1:] -= v[:-1]
        y[:-1] -= v[1:]
        return y
    return op
'''

DUMMY_METRIC = '''
def read(rec):
    return float(rec.window.iterations)
'''


def _copy_benchmark(tmp_path):
    bench_dir = tmp_path / "hpcbench"
    shutil.copytree(ROOT / "hpcbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return bench_dir


def _add_tridiag(bench_dir):
    """The dummy configuration tridiag, its mix cg5 and its cell
    tridiag.cg5, as a later PR would add them: files under `bench_dir`,
    and BENCHMARK.json's entries appended to configs and workloads (the
    caller appends the cell to its metrics' lists)."""
    (bench_dir / "configs" / "tridiag.json").write_text(json.dumps(
        {"name": "tridiag", "rows": 500, "diagonal": 3.0,
         "dtype": "float32", "reduced": []}))
    (bench_dir / "configs" / "tridiag.py").write_text(DUMMY_CONFIG)
    (bench_dir / "reference" / "tridiag.py").write_text(DUMMY_REFERENCE)
    (bench_dir / "small" / "tridiag.json").write_text(json.dumps(
        {"rows": 200}))
    (bench_dir / "traffic" / "cg5.json").write_text(json.dumps(
        {"kind": "solve", "solver": "libhpc_tpu_torch.ops.solver:cg",
         "iterations": 5, "tol": 0.0, "n_rhs": 2, "rhs": "random",
         "sample": 2, "trace_seconds": 0.1}))
    (bench_dir / "limits" / "tridiag.cg5.json").write_text(json.dumps(
        {"limits": {"short": 0, "x_err": 1e-4, "matvec_err": 1e-5}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tridiag", "source": "none",
                             "file": "hpcbench/configs/tridiag.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tridiag.cg5", "config": "tridiag",
                               "traffic": "cg5", "chips": 1, "why": "a test"})
    return bench


def test_a_cell_added_as_files_alone_is_found_and_runs(tmp_path):
    """A later PR adds a configuration, a mix, a metric and a cell by
    adding files and entries: the harness finds and runs them."""
    bench_dir = _copy_benchmark(tmp_path)
    bench = _add_tridiag(bench_dir)
    (bench_dir / "metrics" / "iterations_run.py").write_text(DUMMY_METRIC)
    bench["end_to_end"][0]["workloads"].append("tridiag.cg5")
    bench["per_layer"].append({"name": "iterations_run", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "solver loop",
                               "moves": "requests_per_s",
                               "workloads": ["tridiag.cg5"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = spec.load_benchmark(tmp_path)
    cell = spec.find_cell(loaded, "tridiag.cg5", bench_dir=bench_dir)
    assert cell.traffic["iterations"] == 5
    assert {m["name"] for m in cell.end_to_end} == {"requests_per_s",
                                                    "setup_s"}
    out = harness.run_cell(cell, 9, 0.2, False, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"requests_per_s", "setup_s"}
    traced = harness.run_cell(cell, 9, 0.2, True, device="cpu")
    assert traced["metrics"]["iterations_run"]["value"] >= 5
    with pytest.raises(FileNotFoundError):
        bench["workloads"].append({"name": "tridiag.none", "config": "tridiag",
                                   "traffic": "none", "chips": 1, "why": "x"})
        spec.find_cell(bench, "tridiag.none", bench_dir=bench_dir)


def _hashes(root, names=None):
    names = names or [p.relative_to(root) for p in sorted(root.rglob("*"))
                      if p.is_file() and "__pycache__" not in p.parts]
    return {n: hashlib.sha256((root / n).read_bytes()).hexdigest()
            for n in names}


# the tests of test_hpcbench_runs.py and test_same_seed_same_payloads
# that take each cell of BENCHMARK.json, as the dummy solve cell has them
PER_CELL = ["test_reference_agrees_with_the_programs_plain_path[{}]",
            "test_program_run_is_correct[{}]",
            "test_control_is_not_correct[{}]",
            "test_fault_is_not_correct[{}-altered]",
            "test_fault_is_not_correct[{}-half]",
            "test_fault_is_not_correct[{}-stops_early]",
            "test_fault_is_not_correct[{}-unchanged]",
            "test_traced_run_reads_its_window[{}]",
            "test_same_seed_same_payloads[{}]"]


def test_a_configuration_added_as_files_alone_passes_the_cpu_suite(
        tmp_path):
    """The CPU suite takes a configuration that comes as files and
    appended entries alone: in a copy of the benchmark (and of the port)
    with the dummy tridiag added, the copy's own tests pass for its cell
    as for the others (the control and each planted fault not correct),
    and no file that was there changes."""
    bench_dir = _copy_benchmark(tmp_path)
    shutil.copytree(ROOT / "libhpc_tpu_torch", tmp_path / "libhpc_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    before = _hashes(bench_dir)
    bench = _add_tridiag(bench_dir)
    # the dummy reports what the benchmark's first solve cell reports
    solve = next(w["name"] for w in BENCH["workloads"]
                 if spec.find_cell(BENCH, w["name"]).traffic["kind"]
                 == "solve")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if solve in m.get("workloads", ()):
            m["workloads"].append("tridiag.cg5")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    report = tmp_path / "suite.xml"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "PYTHONPATH"))}
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "hpcbench/tests/test_hpcbench_runs.py",
         "hpcbench/tests/test_hpcbench_generators.py::"
         "test_same_seed_same_payloads", f"--junitxml={report}"],
        cwd=tmp_path, capture_output=True, text=True, timeout=900, env=env)
    assert res.returncode == 0, res.stdout[-4000:]
    passed = {c.get("name") for c in ET.parse(report).iter("testcase")
              if not len(c)}
    for test in PER_CELL:
        for cell in [w["name"] for w in BENCH["workloads"]] + ["tridiag.cg5"]:
            case = test.format(cell)
            if "stops_early" in case and spec.find_cell(
                    bench, cell, bench_dir).traffic["kind"] == "stream":
                continue
            assert case in passed, case
    assert _hashes(bench_dir, list(before)) == before


DUMMY_KIND = '''
"""Kind dummy_sort: a closed loop of one client, each request one sort of
the next of n_keys arrays; judged against the reference's sort."""
import time

import torch

from hpcbench import check, drive


def make_payloads(traffic, inputs, seed, device, ref):
    g = drive.generator(seed, 2, device)
    return torch.randint(0, 2**31 - 1, (traffic["n_keys"], inputs.shape[0]),
                         generator=g, device=device, dtype=torch.int32)


def run(traffic, sort, keys, seconds, seed, device, spans=False, keep=True):
    res = drive.Reservoir(traffic["sample"] if keep else 0,
                          drive.sub_seed(seed, 3))
    win = drive.Window()
    t_start = time.perf_counter()
    while True:
        j = win.attempted % keys.shape[0]
        t0 = time.perf_counter()
        with drive.span(drive.SPAN_REQUEST, spans):
            out = sort(keys[j])
            drive.sync(device)
        t1 = time.perf_counter()
        win.attempted += 1
        win.latencies_s.append(t1 - t0)
        slot = res.slot()
        if slot is not None:
            res.items[slot] = (j, out)
        if t1 - t_start >= seconds:
            break
    win.seconds = t1 - t_start
    win.samples = res.items
    return win


def judge(traffic, window, keys, inputs, ref, device):
    worst = {}
    for j, out in window.samples:
        want = ref.sort(keys[j].cpu().numpy())
        got = out.cpu().numpy().astype(want.dtype)
        check.note(worst, "mismatched", float((got != want).sum()))
    return worst
'''

DUMMY_SORT_CONFIG = '''
from hpcbench.drive import Inputs


def make_inputs(cfg, seed):
    return Inputs(matrix=None, shape=(cfg["n"],))


def build(inputs, cfg, device, variant="program"):
    from libhpc_tpu_torch.ops.sort_merge import merge_sort_u32
    return lambda keys: merge_sort_u32(keys, device=device)
'''

DUMMY_SORT_REFERENCE = '''
import numpy as np


def sort(keys):
    return np.sort(keys.astype(np.uint32))
'''


def test_a_cell_of_a_new_kind_is_added_as_files_alone(tmp_path):
    """A later PR that brings a traffic of another kind (a sort) adds its
    kind, configuration, reference, mix, limits and cell as files and
    entries: the harness finds and runs them, and an end-to-end metric of
    the solves, requests_per_s, reads it without a change."""
    bench_dir = tmp_path / "hpcbench"
    shutil.copytree(ROOT / "hpcbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench_dir / "kinds" / "dummy_sort.py").write_text(DUMMY_KIND)
    (bench_dir / "configs" / "keys_small.json").write_text(json.dumps(
        {"name": "keys_small", "n": 3000, "reduced": []}))
    (bench_dir / "configs" / "keys_small.py").write_text(DUMMY_SORT_CONFIG)
    (bench_dir / "reference" / "keys_small.py").write_text(
        DUMMY_SORT_REFERENCE)
    (bench_dir / "traffic" / "sort1.json").write_text(json.dumps(
        {"kind": "dummy_sort", "n_keys": 3, "sample": 3,
         "trace_seconds": 0.1}))
    (bench_dir / "limits" / "keys_small.sort1.json").write_text(json.dumps(
        {"limits": {"mismatched": 0}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "keys_small", "source": "none",
                             "file": "hpcbench/configs/keys_small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "keys_small.sort1",
                               "config": "keys_small", "traffic": "sort1",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("requests_per_s", "request_ms_p95"):
            m["workloads"].append("keys_small.sort1")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell(spec.load_benchmark(tmp_path), "keys_small.sort1",
                          bench_dir=bench_dir)
    out = harness.run_cell(cell, 2**33 + 1, 0.2, False, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"requests_per_s", "request_ms_p95",
                                   "setup_s"}
    assert out["metrics"]["requests_per_s"]["value"] > 0
    # the kind's judge catches a sort that returns its keys unsorted
    broken = harness.run_cell(cell, 2**33 + 1, 0.2, False, device="cpu",
                              wrap=lambda sort: lambda keys: keys.clone())
    assert not broken["correct"]
    assert broken["checks"]["mismatched"]["value"] > 0


def test_a_checkout_of_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "hpcbench", tmp_path / "hpcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "hpcbench/run.py", "--workload", "hpcg_27pt_256.cg50",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "not in this checkout" in res.stderr


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "libhpc_tpu_torch_x", object())
    assert harness.banned_modules() == [] or all(
        n.split(".")[0] in harness.BANNED for n in harness.banned_modules())
    monkeypatch.setitem(sys.modules, "libhpc_tpu.ops", object())
    assert "libhpc_tpu.ops" in harness.banned_modules()
