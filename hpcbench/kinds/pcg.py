"""Kind ``pcg``: a closed loop of one client, each request one call of the
program's preconditioned solver.

The loop, the right-hand sides and the interface are ``kinds/solve.py``'s
(``n_rhs``, ``rhs``, ``iterations``, ``tol``, ``sample``): each request
solves for the next right-hand side for ``iterations`` iterations at
tolerance ``tol`` and ends in a synchronize; a request that runs fewer
iterations fails. The solver is the program's own (``drive.Program``'s
``solver``: the configuration binds its preconditioner), called with the
matvec ``run`` hands it. A reservoir drawn from the seed keeps ``sample``
requests: the solution x, the input and output of one of the request's
matvecs, and the inputs of its first two matvecs, copied into room made in
set-up.

From x0 = 0 the first matvec applied to a nonzero vector is A p0, with p0
= z0 = M b, the preconditioner's output on the timed path itself (a solver
may first apply A to x0 = 0). So besides ``solve``'s numbers the judge
compares that p0 with the reference's preconditioner applied to b
(``pc_err``): at tolerance 0 a float32 solve reaches its rounding floor
well inside its iterations under a weaker preconditioner too, which
``x_err`` alone would pass.

This kind takes from the reference ``operator(inputs, dtype, device)``,
``vcycle(inputs, dtype, device)`` (the preconditioner M as a function of r)
and ``pcg(op, minv, b, iterations)``.
"""

from __future__ import annotations

import dataclasses
import random
import time
from pathlib import Path

import torch

from hpcbench import check, drive, spec

_SOLVE = spec.load_file(Path(__file__).with_name("solve.py"))

X, V, Y, FIRST = 0, 1, 2, 3      # slots of a kept request: FIRST, FIRST + 1


@dataclasses.dataclass
class Payloads:
    """The right-hand sides, and room made in set-up for what the window
    keeps, so that the window allocates nothing: for each kept request its
    x, the input and output of one of its matvecs and the inputs of its
    first two."""

    bs: torch.Tensor
    kept: torch.Tensor      # (sample, 5, n)


def make_payloads(traffic: dict, inputs, seed: int, device, ref
                  ) -> Payloads:
    bs = _SOLVE.make_payloads(dict(traffic, sample=0), inputs, seed, device,
                              ref).bs
    kept = torch.empty((traffic["sample"], FIRST + 2, inputs.shape[1]),
                       device=device, dtype=torch.float32)
    return Payloads(bs, kept)


def solver_of(traffic: dict, program: drive.Program):
    """The program's solver: this kind names none of its own."""
    if program.solver is None:
        raise ValueError("kind pcg: the configuration's program binds its "
                         "preconditioned solver")
    return program.solver


def run(traffic: dict, program: drive.Program, pl: Payloads,
        seconds: float, seed: int, device, spans: bool = False,
        keep: bool = True) -> drive.Window:
    solve = solver_of(traffic, program)
    iters, tol = traffic["iterations"], traffic["tol"]
    res = drive.Reservoir(traffic["sample"] if keep else 0,
                          drive.sub_seed(seed, 3))
    pick = random.Random(drive.sub_seed(seed, 4))
    win = drive.Window()
    state = {"count": 0, "target": -1, "slot": None, "got": False}

    def matvec(v):
        with drive.span(drive.SPAN_MATVEC, spans):
            y = program.matvec(v)
        slot, count = state["slot"], state["count"]
        if slot is not None:
            if count < 2:
                pl.kept[slot, FIRST + count].copy_(v)
            if count == state["target"]:
                pl.kept[slot, V].copy_(v)
                pl.kept[slot, Y].copy_(y)
                state["got"] = True
        state["count"] = count + 1
        return y

    t_start = time.perf_counter()
    while True:
        k = win.attempted % pl.bs.shape[0]
        slot = res.slot()
        state.update(count=0, slot=slot, got=False,
                     target=pick.randint(1, iters) if slot is not None
                     else -1)
        t0 = time.perf_counter()
        with drive.span(drive.SPAN_REQUEST, spans):
            x, it, _ = solve(matvec, pl.bs[k], tol=tol, max_iter=iters)
            drive.sync(device)
        t1 = time.perf_counter()
        win.attempted += 1
        win.matvecs += state["count"]
        win.iterations += it
        win.latencies_s.append(t1 - t0)
        if it != iters:
            win.failed += 1
        if slot is not None:
            pl.kept[slot, X].copy_(x)
            res.items[slot] = {"rhs": k, "slot": slot, "iterations": it,
                               "matvec": state["got"],
                               "firsts": min(state["count"], 2)}
        if t1 - t_start >= seconds:
            break
    win.seconds = t1 - t_start
    win.samples = res.items
    return win


def judge(traffic: dict, window: drive.Window, pl: Payloads, inputs, ref,
          device) -> dict:
    """``short``, ``x_err`` and ``matvec_err`` as ``kinds/solve.py``'s,
    with ``x_err`` against the reference's PCG (its preconditioner, from
    the same b, as many iterations); ``pc_err``: the input of the kept
    request's first matvec applied to a nonzero vector against the
    reference's preconditioner applied to b."""
    op = ref.operator(inputs, torch.float64, device)
    minv = ref.vcycle(inputs, torch.float64, device)
    worst = {"short": float(window.failed)}
    iters = traffic["iterations"]
    want_x, want_z = {}, {}
    for s in window.samples:
        kept = pl.kept[s["slot"]]
        k = s["rhs"]
        if k not in want_x:
            b = pl.bs[k].to(torch.float64)
            want_z[k] = minv(b)
            want_x[k] = ref.pcg(op, minv, b, iters)
        check.note(worst, "x_err", check.rel_err(kept[X], want_x[k]))
        p0 = next((kept[FIRST + i] for i in range(s["firsts"])
                   if bool(kept[FIRST + i].any())), None)
        check.note(worst, "pc_err", float("inf") if p0 is None
                   else check.rel_err(p0, want_z[k]))
        if not s["matvec"]:      # the solve stopped before it
            check.note(worst, "matvec_err", float("inf"))
            continue
        check.note(worst, "matvec_err",
                   check.rel_err(kept[Y], op(kept[V].to(torch.float64))))
    return worst
