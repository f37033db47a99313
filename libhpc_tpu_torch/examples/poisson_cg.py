"""Solve the 5-point Poisson system with CG and Jacobi-PCG on the DIA
format.

Run: python -m libhpc_tpu_torch.examples.poisson_cg [grid_n] [device]
"""

import sys
import time

import numpy as np
import torch

from libhpc_tpu_torch.bench.matrices import poisson2d
from libhpc_tpu_torch.ops import solver
from libhpc_tpu_torch.sparse import DIA


def main(n: int = 100, device="cuda") -> dict:
    A = poisson2d(n)                     # n^2 rows
    print(f"system: {A.shape[0]} rows, {A.nnz} nnz")
    dia = DIA.from_scipy(A, device=device)   # zero-gather path
    rng = np.random.default_rng(0)
    x_true = rng.random(A.shape[0]).astype(np.float32)
    b = torch.from_numpy(A @ x_true).to(device)

    t0 = time.perf_counter()
    x, it, _ = solver.cg(lambda v: dia @ v, b, tol=1e-6, max_iter=5000)
    err = float((x.cpu() - torch.from_numpy(x_true)).abs().max())
    dt = time.perf_counter() - t0
    print(f"CG: {it} iters, {dt:.3f}s, max|err|={err:.2e}")

    diag = torch.from_numpy(A.diagonal().astype(np.float32)).to(device)
    _, it2, _ = solver.pcg(lambda v: dia @ v, diag, b, tol=1e-6,
                           max_iter=5000)
    print(f"PCG: {it2} iters")
    return {"cg_iterations": it, "pcg_iterations": it2, "max_err": err}


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 100,
         sys.argv[2] if len(sys.argv) > 2 else "cuda")
