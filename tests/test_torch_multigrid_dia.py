"""HPCG's multigrid over DIA levels (``ops/multigrid_dia.py``) and its
multicoloured SymGS (``ops/symgs_dia.py``).

On the CPU the port's plain paths are held to the plain float64 reference
of the benchmark's configuration ``hpcg_mg_256``
(``hpcbench/reference/hpcg_mg_256.py``, written from HPCG's specification),
on the levels its generator makes. Tests marked ``cuda`` hold the SymGS
kernel (``csrc/symgs_dia.cu``) and a whole V-cycle on the card to the plain
paths; they skip without a card. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_multigrid_dia.py
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from hpcbench import spec
from hpcbench.drive import Inputs
from hpcbench.reference import hpcg_mg_256 as ref
from libhpc_tpu_torch.ops import multigrid_dia as mg
from libhpc_tpu_torch.ops import solver, spmv_dia, symgs_dia
from libhpc_tpu_torch.utils.profiling import MG_SMOOTH, MG_VCYCLE

from _torch_port import cuda_device  # noqa: F401  (fixture)

CONFIG = spec.load_file(Path(__file__).resolve().parents[1] / "hpcbench"
                        / "configs" / "hpcg_mg_256.py")
GRIDS = [(16, 16, 16), (8, 16, 24)]


def _inputs(grid, levels=4) -> Inputs:
    nx, ny, nz = grid
    return CONFIG.make_inputs({"nx": nx, "ny": ny, "nz": nz,
                               "levels": levels, "diagonal": 26.0,
                               "off_diagonal": -1.0}, 0)


def _hierarchy(inp, device="cpu"):
    return mg.DiaMultigrid.from_scipy(inp.matrix, inp.sizes["grids"],
                                      device=device)


def _randn(n, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g, dtype=torch.float64).to(dtype)


def _rel(got, want):
    want = want.to(torch.float64)
    return float((got.to(torch.float64) - want).abs().max()
                 / want.abs().max())


def _scipy_27pt(nx, ny, nz, diag=26.0, off=-1.0):
    def axis(n):
        return sps.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(n, n))

    ones = sps.kron(sps.kron(axis(nz), axis(ny)), axis(nx)).tocsr()
    return (off * ones + (diag - off) * sps.identity(nx * ny * nz)).tocsr()


@pytest.mark.parametrize("grid", GRIDS)
def test_one_symgs_matches_the_reference(grid):
    """One SymGS from x = 0 on the finest level: float32 plain path
    against the float64 reference, to 1e-6 of the largest entry."""
    inp = _inputs(grid)
    lv = _hierarchy(inp).levels[0]
    r = _randn(lv.rows, 1)
    x_ext = torch.zeros(spmv_dia.x_ext_len(lv.dp))
    mg.symgs(lv, x_ext, r.float())

    nx, ny, nz = grid
    xp = torch.zeros((nz + 2, ny + 2, nx + 2), dtype=torch.float64)
    ref._symgs(xp, r.view(nz, ny, nx), 26.0, -1.0)
    assert _rel(lv.x(x_ext), xp[1:-1, 1:-1, 1:-1].reshape(-1)) < 1e-6
    # the padding around x is never written
    P = lv.dp.x_pad_lo
    assert not x_ext[:P].any() and not x_ext[P + lv.rows:].any()


@pytest.mark.parametrize("grid", GRIDS)
def test_vcycle_matches_the_reference(grid):
    """HPCG's 4-level V-cycle (down to 2^3, and to 1 x 2 x 3): float32
    against float64, to 1e-6 of the largest entry."""
    inp = _inputs(grid)
    h = _hierarchy(inp)
    r = _randn(inp.shape[0], 2)
    z = mg.vcycle(h, r.float())
    assert z.dtype == torch.float32 and z.shape == r.shape
    assert _rel(z, ref.vcycle(inp, torch.float64, "cpu")(r)) < 1e-6


def test_vcycle_returns_a_new_z_each_call():
    """pcg_op keeps z as p across the next call: the finest x is new."""
    inp = _inputs((16, 16, 16))
    h = _hierarchy(inp)
    r = _randn(inp.shape[0], 3, torch.float32)
    z1 = mg.vcycle(h, r)
    keep = z1.clone()
    z2 = mg.vcycle(h, 2 * r)
    assert z1.data_ptr() != z2.data_ptr() and torch.equal(z1, keep)
    assert torch.allclose(z2, 2 * z1, rtol=1e-5, atol=1e-7)


def test_vcycle_is_symmetric():
    """<M u, v> = <u, M v> to float32 rounding: pre- and post-smoother are
    the same symmetric step and the transfers are each other's transpose."""
    inp = _inputs((16, 16, 16))
    h = _hierarchy(inp)
    u = _randn(inp.shape[0], 4, torch.float32)
    v = _randn(inp.shape[0], 5, torch.float32)
    Mu, Mv = mg.vcycle(h, u), mg.vcycle(h, v)
    a = float(torch.dot(Mu.double(), v.double()))
    b = float(torch.dot(u.double(), Mv.double()))
    scale = float(Mu.double().norm() * v.double().norm())
    assert abs(a - b) < 1e-6 * scale
    # and positive: M is SPD
    assert float(torch.dot(Mu.double(), u.double())) > 0


def test_mgpcg_50_iterations():
    """50 iterations of pcg_op under the V-cycle, as the benchmark calls
    it: x agrees with the reference's PCG, and the residual falls below
    what 50 iterations of unpreconditioned cg reach (and, after 10, a
    hundred times below cg's after 10)."""
    inp = _inputs((16, 16, 16))
    h = _hierarchy(inp)
    op = ref.operator(inp, torch.float64, "cpu")
    b = op(_randn(inp.shape[0], 6)).float()
    fine = h.levels[0].dp

    def matvec(v):
        return spmv_dia.dia_spmv_pallas(fine, v)

    def residual(x):
        b64 = b.double()
        return float((b64 - op(x.double())).norm() / b64.norm())

    def pcg(k):
        return solver.pcg_op(matvec, lambda r: mg.vcycle(h, r), b, tol=0.0,
                             max_iter=k)

    x, it, _ = pcg(50)
    assert it == 50 and torch.isfinite(x).all()
    want = ref.pcg(op, ref.vcycle(inp, torch.float64, "cpu"), b.double(), 50)
    assert _rel(x, want) < 1e-5
    xc, itc, _ = solver.cg(matvec, b, tol=0.0, max_iter=50)
    assert itc == 50
    assert residual(x) < residual(xc)
    x10 = pcg(10)[0]
    xc10 = solver.cg(matvec, b, tol=0.0, max_iter=10)[0]
    assert residual(x10) < residual(xc10) / 100


@pytest.mark.parametrize("grid", GRIDS)
def test_coarse_operators_are_the_stencil_on_the_coarse_grid(grid):
    """Each level is the 27-point operator generated on its grid (each
    axis halved a level), not a Galerkin product, and the container K4
    applies holds it."""
    inp = _inputs(grid)
    h = _hierarchy(inp)
    nx, ny, nz = grid
    for k, lv in enumerate(h.levels):
        g = (nx >> k, ny >> k, nz >> k)
        assert lv.grid == g
        want = _scipy_27pt(*g)
        got = inp.matrix[k].tocsr()
        got.eliminate_zeros()
        assert abs(got - want).max() == 0
        x = _randn(lv.rows, 7 + k)
        y = spmv_dia.dia_spmv_pallas(lv.dp, x.float())
        assert _rel(y, torch.from_numpy(want @ x.numpy())) < 1e-6


def test_hierarchy_refuses_grids_that_do_not_halve():
    inp = _inputs((16, 16, 16), levels=2)
    with pytest.raises(ValueError, match="halved"):
        mg.DiaMultigrid.from_scipy(inp.matrix, [(16, 16, 16), (8, 8, 4)],
                                   device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mg.DiaMultigrid.from_scipy(inp.matrix[::-1],
                                   [(8, 8, 8), (4, 4, 4)], device="cpu")


@pytest.mark.parametrize("grid", [(4, 4, 4), (5, 3, 2), (2, 1, 3)])
def test_colours_split_the_grid_and_hold_no_two_neighbours(grid):
    nx, ny, nz = grid
    z, y, x = np.meshgrid(range(nz), range(ny), range(nx), indexing="ij")
    colour = (x % 2 + 2 * (y % 2) + 4 * (z % 2)).reshape(-1)
    counts = [symgs_dia.colour_rows(grid, c) for c in range(8)]
    assert counts == np.bincount(colour, minlength=8).tolist()
    A = _scipy_27pt(nx, ny, nz).tocoo()
    off = A.row != A.col
    assert not (colour[A.row[off]] == colour[A.col[off]]).any()


def test_sweep_refuses_a_grid_that_does_not_match():
    inp = _inputs((8, 8, 8), levels=1)
    lv = _hierarchy(inp).levels[0]
    x_ext = torch.zeros(spmv_dia.x_ext_len(lv.dp))
    with pytest.raises(ValueError, match="grid"):
        symgs_dia.sweep(lv.dp, (8, 8, 4), x_ext, torch.zeros(512))


def test_spans_and_counter_of_a_vcycle():
    """While a profiler records, a V-cycle is one libhpc.mg.vcycle range
    holding one libhpc.mg.smooth range a SymGS: 2 a level, 1 on the
    coarsest; MG_VCYCLES counts the call."""
    inp = _inputs((16, 16, 16))
    h = _hierarchy(inp)
    r = _randn(inp.shape[0], 8, torch.float32)
    before = mg.MG_VCYCLES
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mg.vcycle(h, r)
    names = [e.name for e in prof.events()]
    assert names.count(MG_VCYCLE) == 1
    assert names.count(MG_SMOOTH) == 2 * 3 + 1
    assert mg.MG_VCYCLES == before + 1


def test_pcg_op_takes_a_quotient_over_zero_as_zero():
    """At tol 0 the products of a solve can underflow float32 while r.r
    stays above 0 (here p.Ap, with z = 1e-30 r): the solve runs its
    iterations and keeps x, where 0 or x / 0 would make it NaN."""
    b = _randn(100, 9, torch.float32)
    x, it, rr = solver.pcg_op(lambda v: 2 * v, lambda r: 1e-30 * r, b,
                              tol=0.0, max_iter=5)
    assert it == 5 and float(rr) > 0
    assert torch.equal(x, torch.zeros_like(b))


@pytest.mark.cuda
@pytest.mark.parametrize("n,colours", [(64, symgs_dia.FORWARD),
                                       (256, (5,))])
def test_symgs_kernel_matches_plain(cuda_device, n, colours):
    """The kernel against its plain version from the same x: a forward
    sweep at 64^3, one colour at 256^3. Both sum a row's 26 neighbours in
    float32, in other orders: 1e-6 of the largest entry."""
    inp = _inputs((n, n, n), levels=1)
    lv = _hierarchy(inp).levels[0]
    x_ext = torch.zeros(spmv_dia.x_ext_len(lv.dp))
    P = lv.dp.x_pad_lo
    x_ext[P:P + lv.rows] = _randn(lv.rows, 10, torch.float32)
    r = _randn(lv.rows, 11, torch.float32)
    dp = lv.dp.to(cuda_device)
    got = x_ext.to(cuda_device)
    before = symgs_dia.SYMGS_LAUNCHES
    symgs_dia.sweep(dp, lv.grid, got, r.to(cuda_device), colours)
    torch.cuda.synchronize()
    assert symgs_dia.SYMGS_LAUNCHES == before + len(colours)
    got = got.cpu()
    x0 = x_ext.clone()
    symgs_dia.sweep_torch(lv.dp, lv.grid, x_ext, r, colours)
    assert _rel(got, x_ext) < 1e-6
    # the rows of other colours and the padding are as they were
    i = torch.arange(lv.rows)
    colour = (i % n) % 2 + 2 * ((i // n % n) % 2) + 4 * ((i // n // n) % 2)
    kept = torch.ones(x_ext.numel(), dtype=torch.bool)
    kept[P + i[torch.isin(colour, torch.tensor(colours))]] = False
    assert torch.equal(got[kept], x0[kept])


@pytest.mark.cuda
def test_symgs_is_8_launches_a_sweep(cuda_device):
    inp = _inputs((32, 32, 32))
    h = _hierarchy(inp, cuda_device)
    r = _randn(inp.shape[0], 12, torch.float32).to(cuda_device)
    before = symgs_dia.SYMGS_LAUNCHES
    mg.vcycle(h, r)
    torch.cuda.synchronize()
    # 4 sweeps on each of 3 levels, 2 on the coarsest
    assert symgs_dia.SYMGS_LAUNCHES - before == 8 * (4 * 3 + 2)


@pytest.mark.cuda
def test_vcycle_on_card_matches_plain(cuda_device):
    """A whole V-cycle at 64^3 (four levels, to 8^3) on the card against
    the plain path: float32 sums in other orders, to 1e-5 of the largest
    entry; and against the float64 reference to 1e-5."""
    inp = _inputs((64, 64, 64))
    plain, card = _hierarchy(inp), _hierarchy(inp, cuda_device)
    r = _randn(inp.shape[0], 13, torch.float32)
    z = mg.vcycle(card, r.to(cuda_device)).cpu()
    assert _rel(z, mg.vcycle(plain, r)) < 1e-5
    assert _rel(z, ref.vcycle(inp, torch.float64, "cpu")(r.double())) < 1e-5
