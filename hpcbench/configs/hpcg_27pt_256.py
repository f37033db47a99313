"""hpcg_27pt_256: HPCG's 27-point stencil at 256^3 on the DIA path.

``make_inputs`` writes the 27 diagonals as a scipy ``dia_matrix`` directly
(no assembled CSR of 449M entries); ``build`` makes the program's container
as ``sparse/auto.py:auto_format`` routes a matrix whose DIA working set is
past ``_DIA_VMEM_BYTES``: ``DIA.from_scipy(..., device="cpu")``, then
``DiaPallas.from_dia``, applied by ``ops/spmv_dia.py:dia_spmv_pallas`` (K4
with ``extend_x``). The matrix does not depend on the seed; the
right-hand sides do. The control is the reference in bfloat16 in the
program's place (the program has no lower-precision DIA path).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from hpcbench.drive import Inputs, Program
from hpcbench.reference import cg as ref_cg


def planes(cfg: dict):
    """(offsets, data): scipy's DIA convention, data[d, j] = A[j - o_d, j],
    for the 27 offsets o = (dz ny + dy) nx + dx in z, y, x order."""
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    # column j's neighbour row j - o lies in the grid iff, on each axis,
    # the coordinate of j minus the step does
    def keep(n, step):
        k = np.ones(n, np.float32)
        if step == 1:
            k[0] = 0
        elif step == -1:
            k[-1] = 0
        return k

    steps = (-1, 0, 1)
    offsets, data = [], np.empty((27, nx * ny * nz), np.float32)
    d = 0
    for dz in steps:
        for dy in steps:
            for dx in steps:
                centre = dx == dy == dz == 0
                v = np.float32(cfg["diagonal"] if centre
                               else cfg["off_diagonal"])
                plane = data[d].reshape(nz, ny, nx)
                np.multiply.outer(np.multiply.outer(keep(nz, dz) * v,
                                                    keep(ny, dy)),
                                  keep(nx, dx), out=plane)
                offsets.append((dz * ny + dy) * nx + dx)
                d += 1
    return np.asarray(offsets, np.int64), data


def make_inputs(cfg: dict, seed: int) -> Inputs:
    offsets, data = planes(cfg)
    data.flags.writeable = False
    N = cfg["nx"] * cfg["ny"] * cfg["nz"]
    A = sps.dia_matrix((data, offsets), shape=(N, N))
    nnz = ((3 * cfg["nx"] - 2) * (3 * cfg["ny"] - 2) * (3 * cfg["nz"] - 2))
    return Inputs(matrix=A, shape=(N, N), nnz=nnz,
                  sizes={k: cfg[k] for k in ("nx", "ny", "nz", "diagonal",
                                             "off_diagonal")})


def build(inputs: Inputs, cfg: dict, device, variant: str = "program"
          ) -> Program:
    if variant == "control":
        from hpcbench.reference import hpcg_27pt_256 as ref

        op = ref.operator(inputs, torch.bfloat16, device)
        return Program(matvec=op, solver=ref_cg.solver(torch.bfloat16))
    if variant != "program":
        raise ValueError(f"variant {variant!r}")
    from libhpc_tpu_torch.ops.spmv_dia import DiaPallas, dia_spmv_pallas
    from libhpc_tpu_torch.sparse.dia import DIA

    dia = DIA.from_scipy(inputs.matrix, device="cpu")
    dp = DiaPallas.from_dia(dia, device=device)
    del dia
    return Program(matvec=lambda v: dia_spmv_pallas(dp, v))


def counters() -> dict:
    """The program's launch counters of this path (one launch a matvec on
    the card; the plain version on the CPU counts none)."""
    from libhpc_tpu_torch.ops import spmv_dia

    return {"DIA_LAUNCHES": spmv_dia.DIA_LAUNCHES}
