"""Plain conjugate gradients, the reference every solve cell is held to.

Textbook CG (Hestenes and Stiefel) from x0 = 0 for a fixed number of
iterations, in the dtype of b, on whatever operator it is given. Written
from the algorithm, not from the program's solver.
"""

from __future__ import annotations

import torch


def cg(op, b: torch.Tensor, iterations: int) -> torch.Tensor:
    x = torch.zeros_like(b)
    r = b - op(x)
    p = r.clone()
    rr = torch.dot(r, r)
    for _ in range(iterations):
        q = op(p)
        alpha = rr / torch.dot(p, q)
        x += alpha * p
        r -= alpha * q
        rr_next = torch.dot(r, r)
        p = r + (rr_next / rr) * p
        rr = rr_next
    return x


def solver(dtype: torch.dtype):
    """This CG as a solver with the program's signature, computed in
    `dtype` (a control puts it in the program's place): returns (x,
    iterations, r.r)."""

    def solve(matvec, b, tol=0.0, max_iter=50):
        x = cg(matvec, b.to(dtype), max_iter)
        return x, max_iter, None

    return solve
