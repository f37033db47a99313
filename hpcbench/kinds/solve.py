"""Kind ``solve``: a closed loop of one client.

Each request is one call of the program's solver (``"solver":
"module:function"``) on the next of ``n_rhs`` right-hand sides, run for
``iterations`` iterations at tolerance ``tol``, and ends in a synchronize;
a request that runs fewer iterations fails. ``"rhs": "random"`` draws b;
``"manufactured"`` draws x* and forms b = A x* with the reference operator
in float64. A reservoir drawn from the seed keeps ``sample`` requests: the
solution x and the input and output of one of the request's matvecs,
copied into room made in set-up.

A kind is a module with three functions, which the harness calls by the
mix's ``kind``:

- ``make_payloads(traffic, inputs, seed, device, ref)``: the mix's inputs
  on the device, from the seed (``ref`` is the configuration's reference
  module), and whatever the window needs allocated beforehand;
- ``run(traffic, program, payloads, seconds, seed, device, spans=False,
  keep=True) -> drive.Window``: drive the program for `seconds` (the last
  request ends past it); ``spans`` wraps requests and matvecs in the
  benchmark's ranges, ``keep`` fills the reservoir;
- ``judge(traffic, window, payloads, inputs, ref, device) -> dict``: each
  number compared, its worst value over the kept answers, from the
  reference, after the window (check.py holds them to their limits).

This kind takes from the configuration a ``drive.Program`` and, from its
reference, ``operator(inputs, dtype, device)``.
"""

from __future__ import annotations

import dataclasses
import importlib
import random
import time

import torch

from hpcbench import check, drive
from hpcbench.reference import cg as ref_cg


@dataclasses.dataclass
class Payloads:
    """The right-hand sides, and room made in set-up for what the window
    keeps, so that the window allocates nothing: for each kept request its
    x and the input and output of one of its matvecs."""

    bs: torch.Tensor
    kept: torch.Tensor      # (sample, 3, n)


def make_payloads(traffic: dict, inputs, seed: int, device, ref
                  ) -> Payloads:
    m, n = inputs.shape
    g = drive.generator(seed, 2, device)
    k = traffic["n_rhs"]
    if traffic["rhs"] == "random":
        bs = torch.randn((k, m), generator=g, device=device,
                         dtype=torch.float32)
    elif traffic["rhs"] == "manufactured":
        xs = torch.randn((k, n), generator=g, device=device,
                         dtype=torch.float64)
        op = ref.operator(inputs, torch.float64, device)
        bs = torch.stack([op(x).to(torch.float32) for x in xs])
        del op, xs
    else:
        raise ValueError(f"rhs {traffic['rhs']!r}")
    kept = torch.empty((traffic["sample"], 3, n), device=device,
                       dtype=torch.float32)
    return Payloads(bs, kept)


def solver_of(traffic: dict, program: drive.Program):
    if program.solver is not None:
        return program.solver
    mod, fn = traffic["solver"].split(":")
    return getattr(importlib.import_module(mod), fn)


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
        if state["count"] == state["target"]:
            pl.kept[state["slot"], 1].copy_(v)
            pl.kept[state["slot"], 2].copy_(y)
            state["got"] = True
        state["count"] += 1
        return y

    t_start = time.perf_counter()
    while True:
        k = win.attempted % pl.bs.shape[0]
        slot = res.slot()
        state["count"] = 0
        state["target"] = pick.randint(1, iters) if slot is not None else -1
        state["slot"] = slot
        state["got"] = False
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
            pl.kept[slot, 0].copy_(x)
            res.items[slot] = {"rhs": k, "slot": slot, "iterations": it,
                               "matvec": state["got"]}
        if t1 - t_start >= seconds:
            break
    win.seconds = t1 - t_start
    win.samples = res.items
    return win


def judge(traffic: dict, window: drive.Window, pl: Payloads, inputs, ref,
          device) -> dict:
    """``short``: requests that ran fewer iterations than asked;
    ``x_err``: a kept solution against the reference's CG from the same
    b, run as many iterations; ``matvec_err``: the kept matvec's y against
    the reference operator on the same input."""
    op = ref.operator(inputs, torch.float64, device)
    worst = {"short": float(window.failed)}
    iters = traffic["iterations"]
    for s in window.samples:
        x, v, y = pl.kept[s["slot"]]
        b = pl.bs[s["rhs"]].to(torch.float64)
        check.note(worst, "x_err",
                   check.rel_err(x, ref_cg.cg(op, b, iters)))
        if not s["matvec"]:      # the solve stopped before it
            check.note(worst, "matvec_err", float("inf"))
            continue
        check.note(worst, "matvec_err",
                   check.rel_err(y, op(v.to(torch.float64))))
    return worst
