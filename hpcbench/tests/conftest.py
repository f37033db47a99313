"""CPU tests of the benchmark harness (``python -m pytest hpcbench/tests``).

Tests marked ``cuda`` need an NVIDIA card and skip without one; whether
there is a card is decided inside the ``cuda_device`` fixture, never at
import or collection time.
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark measures the card)")
    return "cuda"


def shrink(cell):
    """`cell` at its configuration's CPU size: the keys of
    small/<config>.json take the place of the configuration's own, so
    that a whole run of the harness fits a CPU test. Only the tests read
    small/; a run on the card never does."""
    path = cell.bench_dir / "small" / f"{cell.config_name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: a configuration's CPU test size, "
                                "found by its name")
    cell.config.update(json.loads(path.read_text()))
    return cell


@pytest.fixture
def small_cell():
    from hpcbench import spec

    bench = spec.load_benchmark(ROOT)

    def make(name):
        return shrink(spec.find_cell(bench, name,
                                     bench_dir=ROOT / "hpcbench"))

    return make
