"""Reduction of a torch.profiler trace to what the per-layer metrics read.

The traced run exports the profiler's Chrome trace into TMPDIR; ``Trace``
reads it once:

- device operations (kernels, copies, fills) with their intervals, and the
  host time at which each was launched, joined by the profiler's
  correlation id. A kernel that the profiler records with no launch (one
  launched through a library the runtime records none for) takes the
  launch time of the operation before it on its stream, since a stream
  runs its operations in launch order;
- the benchmark's own spans (``hpcbench.*`` record_function ranges) on the
  thread that ran the window, and every host event of that thread.

Times are microseconds on the trace's clock, results seconds.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

from hpcbench import program_spans, stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "hpcbench.window"
NAME_CHARS = 160


class Trace:
    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if len(win) != 1:
            raise ValueError(f"{len(win)} '{WINDOW}' spans in the trace")
        w = win[0]
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.tid = w["tid"]
        launch = {}
        for e in xs:
            if e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = float(e["ts"])
        by_stream: dict = {}
        for e in xs:
            if e.get("cat") in DEVICE_CATS:
                args = e.get("args") or {}
                s = float(e["ts"])
                by_stream.setdefault(args.get("stream"), []).append(
                    [s, s + float(e["dur"]), e.get("name", "?"),
                     launch.get(args.get("correlation"))])
        self.device_ops = []
        self.unlaunched = 0
        for ops in by_stream.values():
            ops.sort()
            prev = None
            for op in ops:
                if op[3] is None:
                    self.unlaunched += 1
                    op[3] = prev
                prev = op[3]
            self.device_ops.extend(tuple(op) for op in ops)
        self.device_ops.sort()
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("name", "?"))
            for e in xs if e.get("cat") in HOST_CATS
            and e.get("tid") == self.tid)
        self.spans: dict = {}
        for e in xs:
            if (e.get("cat") == "user_annotation" and e.get("tid") == self.tid
                    and str(e.get("name", "")).startswith("hpcbench.")):
                s = float(e["ts"])
                self.spans.setdefault(e["name"], []).append(
                    (s, s + float(e["dur"])))
        for v in self.spans.values():
            v.sort()

    @staticmethod
    def load(path: Path) -> "Trace":
        with open(path) as f:
            return Trace(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def span_count(self, name: str) -> int:
        return sum(1 for s, e in self.spans.get(name, ())
                   if s >= self.t0 and e <= self.t1)

    def _inside(self, name: str, t) -> bool:
        spans = self.spans.get(name, ())
        if t is None or not spans:
            return False
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]

    def ops_launched_in(self, span: str, outside: str | None = None):
        """Device operations launched inside a `span` range (and outside
        every `outside` range)."""
        return [op for op in self.device_ops
                if self._inside(span, op[3])
                and not (outside and self._inside(outside, op[3]))]

    def busy_s(self, ops=None) -> float:
        """Seconds of the window in which one of `ops` (every device
        operation by default) ran: the union of their intervals."""
        ops = self.device_ops if ops is None else ops
        return stats.union_length([(s, e) for s, e, _, _ in ops],
                                  self.t0, self.t1) * 1e-6

    def top_device_ops(self, k: int = 10):
        """[[name, seconds]] of the k device operations that took most
        time in the window, summed by name."""
        tot: dict = {}
        for s, e, name, _ in self.device_ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                key = name[:NAME_CHARS]
                tot[key] = tot.get(key, 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """[[host activity, seconds]]: the window's idle device time summed
        by what the host thread was doing, the k largest. A gap that runs
        across the end of the program's convergence sync goes to the sync,
        as ``program_spans.sync_idle_ms_per_iter`` reads it: the host
        left the card idle there, whatever span it had reached by the
        gap's middle. Every other gap goes to the host's innermost event
        at its middle."""
        gaps = stats.gaps([(s, e) for s, e, _, _ in self.device_ops],
                          self.t0, self.t1)
        sync_ends = sorted(e for _, e in program_spans.spans(
            self, program_spans.SYNC))
        tot: dict = {}
        mids = []
        for s, e in gaps:
            j = bisect.bisect_left(sync_ends, s)
            if j < len(sync_ends) and sync_ends[j] <= e:
                key = program_spans.SYNC
                tot[key] = tot.get(key, 0.0) + (e - s) * 1e-6
            else:
                mids.append(((s + e) / 2, e - s))
        mids.sort()
        stack: list = []
        i = 0
        for mid, length in mids:
            while i < len(self.host) and self.host[i][0] <= mid:
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            inner = next((ev for ev in reversed(stack) if ev[1] >= mid),
                         None)
            key = inner[2][:NAME_CHARS] if inner else "host outside any op"
            tot[key] = tot.get(key, 0.0) + length * 1e-6
        return [[n, t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]
