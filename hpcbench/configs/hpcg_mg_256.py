"""hpcg_mg_256: HPCG's multigrid-preconditioned CG at 256^3 on the DIA path.

``make_inputs`` writes each level's 27 diagonals as a scipy
``dia_matrix`` with ``configs/hpcg_27pt_256.py``'s ``planes`` on the grid
halved k times (HPCG's GenerateCoarseProblem: the stencil on the coarse
grid). ``build`` makes the program as users call it:
``ops/multigrid_dia.py:DiaMultigrid.from_scipy`` over the levels, the
solver ``ops/solver.py:pcg_op`` with ``vcycle`` as its preconditioner, and
the matvec ``dia_spmv_pallas`` on the finest level's container (K4 with
``extend_x``; the V-cycle's residual shares it). The matrices do not
depend on the seed; the right-hand sides do. The control is the reference
in bfloat16 in the program's place: its operator and its PCG with its
V-cycle.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.sparse as sps
import torch

from hpcbench import spec
from hpcbench.drive import Inputs, Program

_HPCG = spec.load_file(Path(__file__).with_name("hpcg_27pt_256.py"))


def grids(cfg: dict) -> list:
    """(nx, ny, nz) of each level, finest first: each axis halved a
    level (``DiaMultigrid.from_scipy`` refuses a grid that does not
    halve)."""
    return [tuple(cfg[a] >> k for a in ("nx", "ny", "nz"))
            for k in range(cfg["levels"])]


def _merged(offsets, data):
    """The planes with equal offsets summed into one. On a grid with an
    axis under 3 points two neighbours' offsets can coincide (at nx = 2,
    x + 1 and (x - 1, y + 1) are both 1 row on); their entries never share
    a row, so the sum is exact."""
    uniq, inv = np.unique(offsets, return_inverse=True)
    if len(uniq) == len(offsets):
        return offsets, data
    out = np.zeros((len(uniq), data.shape[1]), data.dtype)
    np.add.at(out, inv, data)
    return uniq, out


def make_inputs(cfg: dict, seed: int) -> Inputs:
    mats = []
    for nx, ny, nz in grids(cfg):
        offsets, data = _merged(*_HPCG.planes(dict(cfg, nx=nx, ny=ny,
                                                     nz=nz)))
        data.flags.writeable = False
        N = nx * ny * nz
        mats.append(sps.dia_matrix((data, offsets), shape=(N, N)))
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    nnz = (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    sizes = {k: cfg[k] for k in ("nx", "ny", "nz", "levels", "diagonal",
                                 "off_diagonal")}
    sizes["grids"] = [list(g) for g in grids(cfg)]
    return Inputs(matrix=mats, shape=mats[0].shape, nnz=nnz, sizes=sizes)


def build(inputs: Inputs, cfg: dict, device, variant: str = "program"
          ) -> Program:
    if variant == "control":
        from hpcbench.reference import hpcg_mg_256 as ref

        return Program(matvec=ref.operator(inputs, torch.bfloat16, device),
                       solver=ref.solver(inputs, torch.bfloat16, device))
    if variant != "program":
        raise ValueError(f"variant {variant!r}")
    from libhpc_tpu_torch.ops.multigrid_dia import DiaMultigrid, vcycle
    from libhpc_tpu_torch.ops.solver import pcg_op
    from libhpc_tpu_torch.ops.spmv_dia import dia_spmv_pallas

    h = DiaMultigrid.from_scipy(inputs.matrix, grids(cfg), device=device)
    fine = h.levels[0].dp

    def solve(matvec, b, tol=0.0, max_iter=50):
        return pcg_op(matvec, lambda r: vcycle(h, r), b, tol=tol,
                      max_iter=max_iter)

    return Program(matvec=lambda v: dia_spmv_pallas(fine, v), solver=solve)


def counters() -> dict:
    """The program's launch counters of this path: K4 (the fine matvec
    and each level's residual), the SymGS kernel (8 launches a sweep, 4
    sweeps a level but the coarsest's 2) and the V-cycles."""
    from libhpc_tpu_torch.ops import multigrid_dia, spmv_dia, symgs_dia

    return {"DIA_LAUNCHES": spmv_dia.DIA_LAUNCHES,
            "SYMGS_LAUNCHES": symgs_dia.SYMGS_LAUNCHES,
            "MG_VCYCLES": multigrid_dia.MG_VCYCLES}
