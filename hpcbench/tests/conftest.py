"""CPU tests of the benchmark harness (``python -m pytest hpcbench/tests``).

Tests marked ``cuda`` need an NVIDIA card and skip without one; whether
there is a card is decided inside the ``cuda_device`` fixture, never at
import or collection time.
"""

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


# small sizes of each configuration for CPU runs of the whole harness
SMALL = {"hpcg_27pt_256": {"nx": 12, "ny": 10, "nz": 9}}


@pytest.fixture
def small_cell():
    from hpcbench import spec

    bench = spec.load_benchmark(ROOT)

    def make(name):
        cell = spec.find_cell(bench, name)
        cell.config.update(SMALL[cell.config_name])
        return cell

    return make
