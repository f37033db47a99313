"""Runs on the card: each listed cell through run.py, untraced and traced,
a few seconds each. Marked ``cuda``; they skip without a card. On the
card: ``python -m pytest hpcbench/tests/test_hpcbench_card.py -q``."""

import json
import subprocess
import sys

import pytest

from hpcbench import spec
from hpcbench.tests.conftest import ROOT

pytestmark = pytest.mark.cuda

BENCH = spec.load_benchmark(ROOT)


def _run(cell, trace):
    res = subprocess.run(
        [sys.executable, "hpcbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 123), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cuda_device, cell, trace):
    out = _run(cell, trace)
    c = spec.find_cell(BENCH, cell)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["count"] == c.chips
    want = c.per_layer if trace else c.end_to_end
    assert set(out["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        for name, m in out["metrics"].items():
            if name.startswith("spmv_roofline_pct"):
                assert 0 < m["value"] <= 100
