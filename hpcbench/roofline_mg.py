"""The yardstick of HPCG's V-cycle smoother (ops/multigrid_dia.py).

A Gauss–Seidel sweep over a level of `rows` points of a 27-point
operator reads each of its 27 plane values once, the right-hand side r
once and x once, and writes x once, whatever the colouring fetches again.
A V-cycle of HPCG's multigrid runs one symmetric Gauss–Seidel step (two
sweeps) before and one after the coarse correction on every level but the
coarsest, which runs one: four sweeps a level, two on the coarsest.
"""

from __future__ import annotations

from hpcbench import roofline

PLANES = 27


def sweep_bytes(rows: int, value_bytes: int = 4) -> int:
    """Least bytes of one sweep: the planes, r and x read, x written."""
    return (PLANES + 3) * rows * value_bytes


def sweep_flops(rows: int) -> int:
    """A multiply and an add a neighbour, a subtract and a divide a row."""
    return 2 * PLANES * rows


def sweeps(levels: int) -> list:
    """Sweeps a V-cycle runs on each level, finest first."""
    return [4] * (levels - 1) + [2]


def smoother_least_seconds(grids, device_kind: str) -> float | None:
    """The least time the card could take for a V-cycle's sweeps on the
    levels `grids` ((nx, ny, nz) each, finest first): each sweep's bytes
    over the bandwidth or its operations over the float32 rate, the
    larger."""
    p = roofline.peak(device_kind)
    if p is None:
        return None
    total = 0.0
    for n, (nx, ny, nz) in zip(sweeps(len(grids)), grids):
        rows = nx * ny * nz
        total += n * max(sweep_bytes(rows) / p["hbm_bytes_per_s"],
                         sweep_flops(rows) / p["fp32_flops_per_s"])
    return total
