"""What every traffic kind shares: the seeds, the program's and the
window's records, the reservoir of kept answers and the benchmark's spans.

A traffic mix (traffic/<mix>.json) names its ``kind``; the kind is the
module kinds/<kind>.py, found by that name. It makes the mix's payloads
from the seed, drives the program through the window and judges the kept
answers against the reference (see kinds/solve.py for the interface).
"""

from __future__ import annotations

import contextlib
import dataclasses
import random

import numpy as np
import torch

SPAN_REQUEST = "hpcbench.request"
SPAN_MATVEC = "hpcbench.matvec"


def sub_seed(seed: int, salt: int) -> int:
    """A 63-bit seed for one purpose, derived from the run's seed."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), salt])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on `device`, seeded for one purpose of the run."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, salt))
    return g


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Inputs:
    """What a configuration's generator makes from the seed: the matrix
    (or other data) the program is built from, its shape, its true
    nonzeros where it has them, and sizes the reference reads
    (``sizes``)."""

    matrix: object
    shape: tuple
    nnz: int | None = None
    sizes: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Program:
    """What a configuration's build returns for the kinds that apply a
    matrix: the matvec users call (its closure holds the program's state)
    and, for a control that replaces the solver too, its solver. A kind of
    another sort states what it takes instead."""

    matvec: object
    solver: object = None


@dataclasses.dataclass
class Window:
    """What one measured window did. ``attempted`` counts requests (a
    solve, a call of a stream); every kind fills ``seconds``."""

    attempted: int = 0
    failed: int = 0
    matvecs: int = 0
    iterations: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    seconds: float = 0.0
    samples: list = dataclasses.field(default_factory=list)


class Reservoir:
    """A uniform sample of k items of a stream of unknown length (Vitter's
    algorithm R), drawn from the seed; whether item i enters is decided
    when it arrives, so the caller keeps only what enters."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: list = []
        self.seen = 0
        self.rng = random.Random(seed)

    def slot(self):
        """The slot the next item takes, or None if it is not kept."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(None)
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


def span(name: str, on: bool):
    """The benchmark's record_function range `name` in a traced run."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())
