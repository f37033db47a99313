"""Kind ``stream``: calls of the program's matvec over ``n_x`` vectors
x ~ N(0, 1), dispatched ahead, with a synchronize every ``sync_every``
calls and at the end; the solver loop is bypassed. A reservoir drawn from
the seed keeps ``sample`` calls' y, copied into room made in set-up. The
interface is kinds/solve.py's; this kind too takes a ``drive.Program``
and the reference's ``operator(inputs, dtype, device)``."""

from __future__ import annotations

import dataclasses
import time

import torch

from hpcbench import check, drive


@dataclasses.dataclass
class Payloads:
    """The vectors x, and room made in set-up for the kept calls' y, so
    that the window allocates nothing."""

    xs: torch.Tensor
    kept: torch.Tensor      # (sample, m)


def make_payloads(traffic: dict, inputs, seed: int, device, ref
                  ) -> Payloads:
    m, n = inputs.shape
    g = drive.generator(seed, 2, device)
    xs = torch.randn((traffic["n_x"], n), generator=g, device=device,
                     dtype=torch.float32)
    kept = torch.empty((traffic["sample"], m), device=device,
                       dtype=torch.float32)
    return Payloads(xs, kept)


def run(traffic: dict, program: drive.Program, pl: Payloads,
        seconds: float, seed: int, device, spans: bool = False,
        keep: bool = True) -> drive.Window:
    res = drive.Reservoir(traffic["sample"] if keep else 0,
                          drive.sub_seed(seed, 3))
    block = traffic["sync_every"]
    win = drive.Window()
    t_start = time.perf_counter()
    while True:
        for _ in range(block):
            j = win.attempted % pl.xs.shape[0]
            with drive.span(drive.SPAN_MATVEC, spans):
                y = program.matvec(pl.xs[j])
            slot = res.slot()
            if slot is not None:
                pl.kept[slot].copy_(y)
                res.items[slot] = {"x": j, "slot": slot}
            win.attempted += 1
        drive.sync(device)
        t1 = time.perf_counter()
        if t1 - t_start >= seconds:
            break
    win.matvecs = win.attempted
    win.seconds = t1 - t_start
    win.samples = res.items
    return win


def judge(traffic: dict, window: drive.Window, pl: Payloads, inputs, ref,
          device) -> dict:
    """``y_err``: each kept call's y against the reference operator on the
    same x."""
    op = ref.operator(inputs, torch.float64, device)
    worst: dict = {}
    want = {}
    for s in window.samples:
        j = s["x"]
        if j not in want:
            want[j] = op(pl.xs[j].to(torch.float64))
        check.note(worst, "y_err",
                   check.rel_err(pl.kept[s["slot"]], want[j]))
    return worst
