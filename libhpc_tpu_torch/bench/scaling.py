"""Weak-scaling SpMV benchmarks over sub-meshes of 1, 2, 4, ... ranks.

Port of ``libhpc_tpu/bench/scaling.py``. Weak scaling: each shard owns a
fixed number of rows; efficiency = (nnz/s at n shards) / (n x nnz/s at 1
shard). Two curves:

  weak_scaling_spmv   DistDIA on a Poisson band (the structured path);
  weak_scaling_sbell  DistSBELL on an unstructured 8 x 8-block FEM-like
                      matrix (block_random grown with the shard count).

Every rank of the process group calls ``run_*`` (a sub-mesh's process
group is made by all of them); the ranks of each sub-mesh time its matvec
with ``bench/harness.py:time_iterated``, a time is the slowest rank's, and
every rank returns the curve, which rank 0 prints.

    python -m libhpc_tpu_torch.bench.scaling [rows_per_shard] \
        [max_devices] [cuda|cpu]
"""

from __future__ import annotations

import json
import sys

import torch
import torch.distributed as dist

from libhpc_tpu_torch.bench.overlap import slowest


def _device_counts(max_devices: int):
    sizes = [1]
    d = 2
    while d <= max_devices:
        sizes.append(d)
        d *= 2
    return sizes


def _emit_curve(name: str, rows_per_shard: int, out: dict,
                device_type: str):
    if dist.get_rank() == 0:
        print(json.dumps({
            "bench": name,
            "rows_per_shard": rows_per_shard,
            "results": out,
            "platform": device_type,
        }), flush=True)


def _curve(build, rows_per_shard: int, max_devices, device_type: str):
    """{n: {ms, gnnz_per_s, efficiency}} over sub-meshes of n ranks;
    build(n, mesh) -> (nnz, matvec, rows_local)."""
    from libhpc_tpu_torch.bench.harness import time_iterated
    from libhpc_tpu_torch.parallel.mesh import (ensure_group, in_mesh,
                                                make_mesh_1d, mesh_device)

    ensure_group(device_type)
    if max_devices is None:
        max_devices = dist.get_world_size()
    out = {}
    base_nnz_rate = None
    for nd in _device_counts(max_devices):
        mesh = make_mesh_1d(nd, device_type=device_type)
        if not in_mesh(mesh):
            continue
        nnz, matvec, rows_local = build(nd, mesh)
        x = torch.ones(rows_local, dtype=torch.float32,
                       device=mesh_device(mesh))
        per = slowest(time_iterated(matvec, x, iters=16, iters_small=2),
                      mesh)
        rate = nnz / per
        if base_nnz_rate is None:
            base_nnz_rate = rate
        out[nd] = dict(
            ms=round(per * 1e3, 3),
            gnnz_per_s=round(rate / 1e9, 3),
            efficiency=round(rate / (base_nnz_rate * nd), 3),
        )
    box = [out]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def run_dia(rows_per_shard: int = 65536, max_devices: int | None = None,
            device_type: str = "cuda"):
    import numpy as np

    from libhpc_tpu_torch.bench.matrices import poisson2d
    from libhpc_tpu_torch.parallel.dist_dia import DistDIA, dist_dia_spmv_fn

    def build(nd, mesh):
        A = poisson2d(int(np.sqrt(rows_per_shard * nd)))
        dA = DistDIA.from_scipy(A, nd).shard(mesh)
        return A.nnz, dist_dia_spmv_fn(dA, mesh), dA.rows_local

    out = _curve(build, rows_per_shard, max_devices, device_type)
    _emit_curve("weak_scaling_spmv", rows_per_shard, out, device_type)
    return out


def run_sbell(rows_per_shard: int = 65536, max_devices: int | None = None,
              blocks_per_row: int = 8, half_band: int = 6,
              device_type: str = "cuda"):
    """DistSBELL weak scaling on the block_random generator (the
    cant/pwtk structural stand-in) grown with the shard count."""
    from libhpc_tpu_torch.bench.matrices import block_random
    from libhpc_tpu_torch.parallel.dist_sbell import (DistSBELL,
                                                      dist_sbell_spmv_fn)

    def build(nd, mesh):
        A = block_random(rows_per_shard * nd // 8,
                         blocks_per_row=blocks_per_row,
                         half_band=half_band, seed=nd)
        dA = DistSBELL.from_scipy(A, nd).shard(mesh)
        return A.nnz, dist_sbell_spmv_fn(dA, mesh), dA.rows_local

    out = _curve(build, rows_per_shard, max_devices, device_type)
    _emit_curve("weak_scaling_sbell", rows_per_shard, out, device_type)
    return out


def run(rows_per_shard: int = 65536, max_devices: int | None = None,
        device_type: str = "cuda"):
    dia = run_dia(rows_per_shard, max_devices, device_type)
    sbell = run_sbell(rows_per_shard, max_devices, device_type=device_type)
    return {"dia": dia, "sbell": sbell}


if __name__ == "__main__":
    from libhpc_tpu_torch.parallel.mesh import run_in_group

    argv = sys.argv[1:]
    dt = argv.pop() if argv and argv[-1] in ("cuda", "cpu") else "cuda"
    ints = [int(a) for a in argv]
    nd = ints[1] if len(ints) > 1 else (
        torch.cuda.device_count() if dt == "cuda" else 8)
    run_in_group(nd, run, (*(ints[:1] or [65536]), nd, dt), device_type=dt)
