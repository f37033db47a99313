"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, the traffic
kind's ``judge`` (kinds/<kind>.py) holds the answers the window kept
against the plain reference (reference/<config>.py, float64) and returns
each number compared. An error is the largest absolute difference over
the largest absolute entry of the reference's answer: one entry altered
shows at its own size, not diluted over millions. Each number has its
limit in limits/<cell>.json; a run is correct when every number is at or
under its limit and the window kept something to judge.
"""

from __future__ import annotations

import torch


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.to(torch.float64)
    scale = want.abs().max()
    return float((got.to(torch.float64) - want).abs().max() / scale)


def note(worst: dict, name: str, value: float) -> None:
    """Keep the larger of `value` and what `worst` holds under `name`."""
    worst[name] = max(worst.get(name, 0.0), value)


def verdict(worst: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) for every limited number."""
    checks = {}
    ok = True
    for name, lim in limits["limits"].items():
        value = worst.get(name)
        checks[name] = {"value": value, "limit": lim}
        if value is None or not value <= lim:
            ok = False
    return ok, checks
