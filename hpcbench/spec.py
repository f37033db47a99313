"""BENCHMARK.json and the files the harness finds by name.

Nothing here names a cell, a configuration, a traffic mix or a metric: a
cell ``<config>.<mix>`` of BENCHMARK.json is served by

  configs/<config>.json      the configuration's sizes, source and cuts
  configs/<config>.py        its generator and how the program is built
  reference/<config>.py      its plain reference operator
  traffic/<mix>.json         the traffic mix's parameters, its "kind" named
  kinds/<kind>.py            the code of that kind of traffic: payloads,
                             the window's loop and the judge
  limits/<cell>.json         the limit of each number compared
  metrics/<metric>.py        one reader a metric, end-to-end ones included

so that a later cell, mix or metric comes as new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with its files read."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell_name: str) -> bool:
    cells = metric.get("workloads")
    return cells is None or cell_name in cells


def find_cell(bench: dict, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The workload `name` of `bench` with its configuration, traffic mix
    and limits read from their files under `bench_dir`."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"workload {name!r}: {len(entries)} entries in "
                       "BENCHMARK.json")
    w = entries[0]
    return make_cell(bench, name, w["config"], w["traffic"], int(w["chips"]),
                     bench_dir)


def make_cell(bench: dict, name: str, config_name: str, traffic_name: str,
              chips: int = 1, bench_dir: Path = BENCH_DIR,
              limits: dict | None = None) -> Cell:
    """A cell of `config_name` under `traffic_name` read from the files
    under `bench_dir`; `limits` in place of limits/<name>.json serves a
    cell that BENCHMARK.json does not list (the CPU tests)."""
    bench_dir = Path(bench_dir)
    if limits is None:
        limits = _read_json(bench_dir / "limits" / f"{name}.json")
    return Cell(
        name=name, chips=chips, config_name=config_name,
        traffic_name=traffic_name,
        config=_read_json(bench_dir / "configs" / f"{config_name}.json"),
        traffic=_read_json(bench_dir / "traffic" / f"{traffic_name}.json"),
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir)


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path}: the harness finds this file by "
                                "its name in BENCHMARK.json")
    return json.loads(path.read_text())


def load_file(path: Path):
    """Import the Python file `path` (its name may hold dots, as a
    metric's does) as a module of its own."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"{path}: the harness finds this file by "
                                "its name in BENCHMARK.json")
    mod_name = "hpcbench_file_" + re.sub(r"\W", "_", str(path))
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def config_module(cell: Cell):
    return load_file(cell.bench_dir / "configs" / f"{cell.config_name}.py")


def reference_module(cell: Cell):
    return load_file(cell.bench_dir / "reference" / f"{cell.config_name}.py")


def kind_module(cell: Cell):
    return load_file(cell.bench_dir / "kinds" / f"{cell.traffic['kind']}.py")


def metric_reader(cell: Cell, metric_name: str):
    return load_file(cell.bench_dir / "metrics" / f"{metric_name}.py").read
