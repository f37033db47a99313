"""Statistics of a window: percentiles over all requests, rates over the
whole window, and interval unions for the device's busy time."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of every value, by linear
    interpolation between the two nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"rate over a window of {seconds} s")
    return count / seconds


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals, lo: float | None = None,
                 hi: float | None = None) -> float:
    """Length of the union of the intervals, clipped to [lo, hi]."""
    total = 0.0
    for s, e in merge(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e > s:
            total += e - s
    return total


def gaps(busy, lo: float, hi: float):
    """The idle intervals of [lo, hi] between the merged busy ones."""
    out, t = [], lo
    for s, e in merge(busy):
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out
