"""Multigrid V-cycles against CG on the Poisson model problem.

Run: python -m libhpc_tpu_torch.examples.multigrid_demo [k] [device]
(the grid is (2^k - 1)^2)
"""

import sys
import time

import numpy as np
import torch

from libhpc_tpu_torch.bench.matrices import poisson2d
from libhpc_tpu_torch.ops import multigrid as mg
from libhpc_tpu_torch.ops import solver
from libhpc_tpu_torch.sparse import DIA


def main(k: int = 7, device="cuda") -> dict:
    n = (1 << k) - 1
    h = 1.0 / (n + 1)
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.random((n, n)).astype(np.float32)).to(device)

    t0 = time.perf_counter()
    u, res = mg.mg_solve(f, h=h, n_cycles=10)
    res = float(res)                     # waits for the device
    print(f"MG: {n}x{n} grid, 10 V-cycles in "
          f"{time.perf_counter() - t0:.3f}s, |r|={res:.2e}")

    A = poisson2d(n) / (h * h)
    dia = DIA.from_scipy(A, device=device)
    t0 = time.perf_counter()
    _, it, _ = solver.cg(lambda v: dia @ v, f.reshape(-1), tol=1e-6,
                         max_iter=5000)
    print(f"CG: {it} iters in {time.perf_counter() - t0:.3f}s")
    return {"mg_residual": res, "cg_iterations": it}


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 7,
         sys.argv[2] if len(sys.argv) > 2 else "cuda")
