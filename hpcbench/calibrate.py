"""Readings that the limits of limits/<cell>.json are set from.

    python hpcbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--variant program|control] [--seconds 3]

runs the cell once a seed in one process (the card, imports and the
kernels' build are paid once) and prints, a seed, one JSON line with every
number compared (``worst``) and the run's verdict against the current
limits. ``--variant control`` puts the configuration's control in the
program's place (configs/<config>.json names it): its numbers set the
upper reading, the program's over a dozen seeds the lower one. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="program",
                    choices=("program", "control"))
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from hpcbench import harness, spec

    if not torch.cuda.is_available():
        sys.exit("hpcbench: no CUDA device")
    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False,
                               variant=args.variant)
        print(json.dumps({
            "workload": cell.name, "variant": args.variant, "seed": seed,
            "correct": out["correct"], "attempted": out["attempted"],
            "worst": {k: v["value"] for k, v in out["checks"].items()},
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
