"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` is device-agnostic so that the CPU tests can drive a whole
run at a small size with the program's plain paths; ``run.py`` is the
entry point on the card and refuses to run without one.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch

from hpcbench import check, drive, spec
from hpcbench.layers import Record
from hpcbench.trace import WINDOW, Trace

BANNED = ("jax", "jaxlib", "flax", "libhpc_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (libhpc_tpu_torch is neither)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in BANNED})


def power_limit_w():
    """The card's power limit from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _traced_window(kind, cell, program, payloads, seconds, seed, device):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            win = kind.run(cell.traffic, program, payloads, seconds, seed,
                           device, spans=True)
        drive.sync(device)
    fd, path = tempfile.mkstemp(prefix="hpcbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        del prof
        tr = Trace.load(path)
    finally:
        os.unlink(path)
    return win, tr


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", variant: str = "program", t_start=None,
             wrap=None, marks=()) -> dict:
    """Run `cell` once and return the result line as a dict (``checks``
    last). `variant` "control" builds the configuration's control in the
    program's place; `wrap`, a function of the built program, lets a test
    break the timed path underneath the harness; `marks`, (phase, time)
    pairs the caller took after `t_start`, split the set-up before this
    call."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    cfg_mod = spec.config_module(cell)
    ref_mod = spec.reference_module(cell)
    kind = spec.kind_module(cell)

    marks = [("start", t_start), *marks]
    marks.append(("imports" if len(marks) == 1 else "harness",
                  time.perf_counter()))
    inputs = cfg_mod.make_inputs(cell.config, seed)
    marks.append(("inputs", time.perf_counter()))
    payloads = kind.make_payloads(cell.traffic, inputs, seed, device,
                                  ref_mod)
    if cuda:
        drive.sync(device)
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("payloads", time.perf_counter()))
    program = cfg_mod.build(inputs, cell.config, device, variant)
    drive.sync(device)
    marks.append(("build", time.perf_counter()))
    if wrap is not None:
        program = wrap(program)
    # warm-up: every shape the window uses, the kernels' first build and
    # load included
    kind.run(cell.traffic, program, payloads, 0.0, seed, device, keep=False)
    drive.sync(device)
    marks.append(("warm_up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    phases = {name: t - marks[i][1]
              for i, (name, t) in enumerate(marks[1:])}
    build_s = phases["build"]

    counters = getattr(cfg_mod, "counters", dict)
    before = counters()
    tr = None
    if trace:
        win, tr = _traced_window(kind, cell, program, payloads,
                                 min(seconds, cell.traffic["trace_seconds"]),
                                 seed, device)
    else:
        win = kind.run(cell.traffic, program, payloads, seconds, seed,
                       device)
    launched = {k: v - before[k] for k, v in counters().items()}
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    card = torch.cuda.get_device_name(device) if cuda else "cpu"

    rec = Record(cell=cell, inputs=inputs, window=win, setup_s=setup_s,
                 build_s=build_s, device_kind=card, trace=tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(cell, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the reference runs once the program's state is freed
    del program
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    worst = kind.judge(cell.traffic, win, payloads, inputs, ref_mod, device)
    check_s = time.perf_counter() - t_check
    ok, checks = check.verdict(worst, cell.limits)
    ok = ok and win.attempted > 0 and len(win.samples) > 0

    dev = {"platform": "gpu" if cuda else "cpu", "kind": card,
           "count": cell.chips, "memory_peak_bytes": mem_peak}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        dev["launches_unmatched"] = tr.unlaunched
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    out = {"correct": ok, "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": dev,
           "nnz": getattr(inputs, "nnz", None), "matvecs": win.matvecs,
           "counters": launched,
           "setup_phases_s": phases, "check_s": check_s}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr.top_device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out
