"""Run one cell of BENCHMARK.json on the card and print its result line.

    python hpcbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1
breakdown, and last ``checks``: each number compared with its limit); the
last lines of standard error repeat the checks. It exits non-zero and
prints no result without a CUDA card (or with fewer than the cell asks
for), without the port's package in the checkout, or when JAX or the JAX
package was loaded. Compiled bytecode is cached in ``_pycache/`` inside
the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# Python's compiled bytecode (torch's ~2,100 modules, the port's, the
# harness's) is cached in the checkout at a fixed path, as the kernels
# are, even where the environment asks for none (PYTHONDONTWRITEBYTECODE):
# without it every run compiles torch from source, 7-10 s of set-up on
# an H100 machine. Only a checkout's first run writes it.
PYCACHE = ROOT / "_pycache"
sys.pycache_prefix = str(PYCACHE)
sys.dont_write_bytecode = False


def fail(msg: str, code: int) -> None:
    print(f"hpcbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from hpcbench import spec

    try:
        cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload)
    except (KeyError, FileNotFoundError) as e:
        fail(str(e), 2)

    try:
        import libhpc_tpu_torch
    except ImportError as e:
        fail(f"the port's package is not in this checkout: {e}", 2)
    if ROOT not in Path(libhpc_tpu_torch.__file__).resolve().parents:
        fail(f"libhpc_tpu_torch was imported from "
             f"{libhpc_tpu_torch.__file__}, outside this checkout", 2)
    import torch

    t_imports = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card and does not "
             "fall back to the CPU", 2)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present", 2)

    torch.zeros(1, device="cuda")        # the card's context
    t_cuda = time.perf_counter()
    from hpcbench import harness

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START,
                           marks=[("imports", t_imports),
                                  ("cuda_init", t_cuda)])
    found = harness.banned_modules()
    if found:
        fail(f"JAX or the JAX package was loaded: {', '.join(found)}", 3)
    print(f"hpcbench: {cell.name} seed {args.seed}: nnz {out['nnz']}, "
          f"attempted {out['attempted']}, failed {out['failed']}, "
          f"correct {str(out['correct']).lower()}", file=sys.stderr)
    print("hpcbench: set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in out["setup_phases_s"].items())
        + f"; check {out['check_s']:.3f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
