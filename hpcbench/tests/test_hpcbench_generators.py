"""The configurations' generators: the HPCG planes equal to scipy's
27-point matrix, the full size's counts, the route auto_format takes, and
for every cell the seed's payloads."""

import pytest
import scipy.sparse as sps
import torch

from hpcbench import spec
from hpcbench.tests.conftest import ROOT

CELLS = [w["name"] for w in spec.load_benchmark(ROOT)["workloads"]]


def _config(name, **over):
    c = spec.make_cell(spec.load_benchmark(ROOT), name, name, "spmv",
                       limits={})
    c.config.update(over)
    return c, spec.config_module(c)


def _scipy_27pt(nx, ny, nz, diag, off):
    def axis(n):
        return sps.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(n, n))

    ones = sps.kron(sps.kron(axis(nz), axis(ny)), axis(nx)).tocsr()
    return (off * ones + (diag - off) * sps.identity(nx * ny * nz)).tocsr()


def test_hpcg_planes_equal_scipys_27_point_matrix():
    c, mod = _config("hpcg_27pt_256", nx=5, ny=4, nz=3)
    inp = mod.make_inputs(c.config, 1)
    want = _scipy_27pt(5, 4, 3, 26.0, -1.0)
    got = inp.matrix.tocsr()
    got.eliminate_zeros()
    assert abs(got - want).max() == 0
    assert got.nnz == want.nnz == inp.nnz == (3 * 5 - 2) * (3 * 4 - 2) * (3 * 3 - 2)


def test_hpcg_full_size_counts():
    c, _ = _config("hpcg_27pt_256")
    cfg = c.config
    n = cfg["nx"]
    assert cfg["rows"] == n ** 3
    assert cfg["nnz"] == (3 * n - 2) ** 3 == 449_455_096


def test_hpcg_full_size_is_past_the_dia_threshold():
    """auto_format takes the streaming DiaPallas route once the DIA
    working set (planes + x + y) passes _DIA_VMEM_BYTES; the benchmark
    builds that route directly."""
    from libhpc_tpu_torch.sparse import auto

    c, _ = _config("hpcg_27pt_256")
    cfg = c.config
    N = cfg["rows"]
    work = cfg["planes"] * N * 4 + 2 * N * 4
    assert cfg["planes"] <= auto._DIA_MAX_OFFSETS
    assert cfg["nnz"] >= 0.25 * cfg["planes"] * N     # DIA fill test
    assert work > auto._DIA_VMEM_BYTES


def test_auto_format_routes_a_small_hpcg_to_diapallas(monkeypatch):
    from libhpc_tpu_torch.ops.spmv_dia import DiaPallas
    from libhpc_tpu_torch.sparse import auto

    c, mod = _config("hpcg_27pt_256", nx=8, ny=8, nz=8)
    A = mod.make_inputs(c.config, 1).matrix
    monkeypatch.setattr(auto, "_DIA_VMEM_BYTES", 1024)
    container, _ = auto.auto_format(A.tocsr(), device="cpu")
    assert isinstance(container, DiaPallas)


def _seeded(payloads):
    """The tensors a kind draws from the seed: the payloads themselves,
    or the fields of its payload object less ``kept``, the room made in
    set-up for what the window keeps."""
    if isinstance(payloads, torch.Tensor):
        return [payloads]
    return [v for k, v in vars(payloads).items()
            if k != "kept" and isinstance(v, torch.Tensor)]


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_payloads(small_cell, name):
    """The configuration's data is made once; the mix's payloads are the
    seed's, the same for the same seed, in the configuration's dtype."""
    cell = small_cell(name)
    inp = spec.config_module(cell).make_inputs(cell.config, 1)
    ref = spec.reference_module(cell)
    kind = spec.kind_module(cell)

    def make(seed):
        return _seeded(kind.make_payloads(cell.traffic, inp, seed, "cpu",
                                          ref))

    a, b, other = make(2**31 + 5), make(2**31 + 5), make(2**40 + 7)
    assert a and len(a) == len(b) == len(other)
    for x in a:
        assert x.shape[-1] == inp.shape[0]
        if x.is_floating_point() and "dtype" in cell.config:
            assert x.dtype == getattr(torch, cell.config["dtype"])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, other))
