"""Halo-exchange overlap benchmark of the distributed stencil.

Port of ``libhpc_tpu/bench/overlap.py``: the distributed radius-r box blur
(``parallel/dist_stencil.py``) with and without the interior / boundary
overlap split, and

  overlap_efficiency = t_unoverlapped / t_overlapped

(>= 1: the halo exchange hides under the interior compute). Each rank of
the mesh runs the same chain, timed by ``bench/harness.py:time_iterated``;
a time is the slowest rank's (an all_reduce of the maximum), so every rank
returns the same efficiency and rank 0 prints the reference's JSON record.
``run`` runs in each rank of the process group (all of them must call
it); a mesh of one rank measures the split's cost with no exchange.

    python -m libhpc_tpu_torch.bench.overlap [n_devices] [m] [n] [radius] \
        [cuda|cpu]

starts n_devices ranks (one a card, or gloo ranks on the CPU) unless it
runs under torchrun.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.distributed as dist


def slowest(seconds: float, mesh) -> float:
    """The largest of the mesh's ranks' times."""
    t = torch.tensor([seconds], dtype=torch.float64)
    if mesh.device_type == "cuda":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(0))
    return float(t.item())


def run(n_devices: int | None = None, m: int = 4096, n: int = 4096,
        radius: int = 8, device_type: str = "cuda"):
    from libhpc_tpu_torch.bench.harness import time_iterated
    from libhpc_tpu_torch.parallel.dist_stencil import dist_blur2d_fn
    from libhpc_tpu_torch.parallel.mesh import make_mesh_1d, mesh_device

    mesh = make_mesh_1d(n_devices, device_type=device_type)
    nd = mesh.size()
    u = torch.ones((m // nd, n), dtype=torch.float32,
                   device=mesh_device(mesh))

    norm = 1.0 / float((2 * radius + 1) ** 2)
    results = {}
    for overlap in (False, True):
        f = dist_blur2d_fn(mesh, radius=radius, overlap=overlap)
        per = time_iterated(lambda v: f(v) * norm, u, iters=16,
                            iters_small=2)
        results["overlapped" if overlap else "unoverlapped"] = \
            slowest(per, mesh)

    eff = results["unoverlapped"] / results["overlapped"]
    if mesh.get_rank() == 0:
        print(json.dumps({
            "bench": "halo_overlap_stencil",
            "n_devices": nd,
            "shape": [m, n],
            "radius": radius,
            "ms_unoverlapped": round(results["unoverlapped"] * 1e3, 3),
            "ms_overlapped": round(results["overlapped"] * 1e3, 3),
            "overlap_efficiency": round(eff, 3),
            "platform": device_type,
        }), flush=True)
    return eff


if __name__ == "__main__":
    from libhpc_tpu_torch.parallel.mesh import run_in_group

    argv = sys.argv[1:]
    dt = argv.pop() if argv and argv[-1] in ("cuda", "cpu") else "cuda"
    ints = [int(a) for a in argv]
    nd = ints[0] if ints else (torch.cuda.device_count() if dt == "cuda"
                               else 8)
    run_in_group(nd, run, (nd, *ints[1:], dt), device_type=dt)
