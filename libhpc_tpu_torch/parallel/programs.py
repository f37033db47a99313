"""Whole-input programs of the distributed layer, one a function.

Each takes host inputs (scipy matrices, numpy arrays), builds the mesh of
the current process group, gives this rank its shard of every input, runs
the layer's function on it and returns this rank's result as numpy (and
an iteration count and squared residual for the solvers). They are what
``mesh.launch`` and ``mesh.RankPool`` run in every rank: the port's CPU
tests, the dry run and the examples call the layer through them. Joining
the ranks' results along their leading axis gives the global result.

``device_type`` picks the mesh's device: the card by default, "cpu" for
gloo ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from libhpc_tpu_torch.parallel import halo as _halo
from libhpc_tpu_torch.parallel.mesh import (make_mesh_1d, make_mesh_2d,
                                            mesh_device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def rows_of(a, mesh, axis: str = "x") -> torch.Tensor:
    """This rank's block of rows (axis 0) of host array a, on the mesh's
    device."""
    n = mesh.shape[mesh.mesh_dim_names.index(axis)]
    k = a.shape[0] // n
    i = mesh.get_local_rank(axis)
    part = np.ascontiguousarray(np.asarray(a)[i * k:(i + 1) * k])
    return torch.from_numpy(part).to(mesh_device(mesh))


def block_of(a, mesh, axes=("py", "px")) -> torch.Tensor:
    """This rank's (row, column) block of the 2-D host array a, sharded
    over both axes of a 2-D mesh."""
    i, j = (mesh.get_local_rank(ax) for ax in axes)
    pr, pc = (mesh.shape[mesh.mesh_dim_names.index(ax)] for ax in axes)
    kr, kc = a.shape[0] // pr, a.shape[1] // pc
    part = np.ascontiguousarray(
        np.asarray(a)[i * kr:(i + 1) * kr, j * kc:(j + 1) * kc])
    return torch.from_numpy(part).to(mesh_device(mesh))


def _solve_out(x, it, res2):
    return _numpy(x), int(it), float(res2)


# --- collectives, halo exchange and stencils --------------------------------


def collectives(x, wrap: bool = False, device_type="cuda"):
    """Every function of collectives.py on this rank's row shard of x:
    {name: numpy result} (my_index as an int)."""
    from libhpc_tpu_torch.parallel import collectives as c

    mesh = make_mesh_1d(device_type=device_type)
    xs = rows_of(x, mesh)
    return {"all_reduce_sum": _numpy(c.all_reduce_sum(xs, "x", mesh=mesh)),
            "all_gather": _numpy(c.all_gather(xs, "x", mesh=mesh)),
            "all_gather_stacked": _numpy(c.all_gather(xs, "x", False,
                                                      mesh=mesh)),
            "reduce_scatter": _numpy(c.reduce_scatter(xs, "x", mesh=mesh)),
            "shift_up": _numpy(c.shift_up(xs, "x", wrap, mesh=mesh)),
            "shift_down": _numpy(c.shift_down(xs, "x", wrap, mesh=mesh)),
            "my_index": c.my_index("x", mesh=mesh)}


def halo_exchange(x, halo: int, wrap: bool = False, device_type="cuda"):
    """(top, bottom) halos of this rank's row shard of x."""
    mesh = make_mesh_1d(device_type=device_type)
    top, bot = _halo.exchange_halo_1d(rows_of(x, mesh), halo, "x", wrap,
                                      mesh=mesh)
    return _numpy(top), _numpy(bot)


def _three_point(h: int):
    """A stencil of the (m + 2h) -> m form with distinct weights, so that a
    misplaced halo row shows: out[i] = p[i] + 2 p[i + h] + 3 p[i + 2h]."""
    def stencil(p):
        m = p.shape[0] - 2 * h
        return p[:m] + 2.0 * p[h:h + m] + 3.0 * p[2 * h:2 * h + m]

    return stencil


def halo_stencil(x, halo: int, wrap: bool = False, device_type="cuda"):
    """halo_stencil_overlapped of _three_point(halo) on this rank's row
    shard, and the same stencil on exchange_to_halo's padded array."""
    mesh = make_mesh_1d(device_type=device_type)
    xs = rows_of(x, mesh)
    out = _halo.halo_stencil_overlapped(xs, _three_point(halo), halo, "x",
                                        wrap, mesh=mesh)
    ha = _halo.exchange_to_halo(xs, halo, "x", wrap, mesh=mesh)
    return _numpy(out), _numpy(_three_point(halo)(ha.data))


def pad_2d(x, halo: int, grid, wrap: bool = False, device_type="cuda"):
    """pad_with_halo_2d of this rank's block of x on a (py, px) mesh."""
    mesh = make_mesh_2d(*grid, ("py", "px"), device_type=device_type)
    return _numpy(_halo.pad_with_halo_2d(block_of(x, mesh), halo,
                                         mesh=mesh, wrap=wrap))


def blur2d(a, radius: int, overlap: bool = True, device_type="cuda"):
    from libhpc_tpu_torch.parallel.dist_stencil import dist_blur2d_fn

    mesh = make_mesh_1d(device_type=device_type)
    f = dist_blur2d_fn(mesh, radius=radius, overlap=overlap)
    return _numpy(f(rows_of(a, mesh)))


def poisson(u, device_type="cuda"):
    from libhpc_tpu_torch.parallel.dist_stencil import dist_poisson_fn

    mesh = make_mesh_1d(device_type=device_type)
    return _numpy(dist_poisson_fn(mesh)(rows_of(u, mesh)))


def poisson3d(u, device_type="cuda"):
    from libhpc_tpu_torch.parallel.dist_stencil import dist_poisson3d_fn

    mesh = make_mesh_1d(device_type=device_type)
    return _numpy(dist_poisson3d_fn(mesh)(rows_of(u, mesh)))


def poisson_2dmesh(u, grid, device_type="cuda"):
    from libhpc_tpu_torch.parallel.dist_stencil import dist_poisson_2dmesh_fn

    mesh = make_mesh_2d(*grid, ("py", "px"), device_type=device_type)
    return _numpy(dist_poisson_2dmesh_fn(mesh)(block_of(u, mesh)))


# --- sparse products and solvers --------------------------------------------


def csr_spmv(A, x, device_type="cuda"):
    """This rank's y of the DistCSR matvec; x padded to the partition."""
    from libhpc_tpu_torch.parallel.dist_spmv import DistCSR, dist_spmv_fn

    mesh = make_mesh_1d(device_type=device_type)
    dA = DistCSR.from_scipy(A, mesh.size()).shard(mesh)
    return _numpy(dist_spmv_fn(dA, mesh)(rows_of(x, mesh)))


def csr_spmm(A, B, device_type="cuda"):
    from libhpc_tpu_torch.parallel.dist_spmv import DistCSR, dist_spmm_fn

    mesh = make_mesh_1d(device_type=device_type)
    dA = DistCSR.from_scipy(A, mesh.size()).shard(mesh)
    return _numpy(dist_spmm_fn(dA, mesh, B.shape[1])(rows_of(B, mesh)))


def csr_cg(A, b, tol=1e-6, max_iter=1000, device_type="cuda"):
    from libhpc_tpu_torch.parallel.dist_spmv import DistCSR, dist_cg

    mesh = make_mesh_1d(device_type=device_type)
    dA = DistCSR.from_scipy(A, mesh.size()).shard(mesh)
    return _solve_out(*dist_cg(dA, rows_of(b, mesh), mesh, tol=tol,
                               max_iter=max_iter))


def dia_spmv(A, x, device_type="cuda"):
    from libhpc_tpu_torch.parallel.dist_dia import DistDIA, dist_dia_spmv_fn

    mesh = make_mesh_1d(device_type=device_type)
    dA = DistDIA.from_scipy(A, mesh.size()).shard(mesh)
    return _numpy(dist_dia_spmv_fn(dA, mesh)(rows_of(x, mesh)))


def dia_cg(A, b, tol=1e-6, max_iter=1000, device_type="cuda"):
    from libhpc_tpu_torch.parallel.dist_dia import DistDIA, dist_dia_cg

    mesh = make_mesh_1d(device_type=device_type)
    dA = DistDIA.from_scipy(A, mesh.size()).shard(mesh)
    return _solve_out(*dist_dia_cg(dA, rows_of(b, mesh), mesh, tol=tol,
                                   max_iter=max_iter))


def dist2d_spmv(A, x, grid, realign: bool = True, device_type="cuda"):
    """This rank's block of y: its px block of x's distribution
    (realign=True) or its py block (realign=False)."""
    from libhpc_tpu_torch.parallel.dist2d import Dist2DCSR, dist2d_spmv_fn

    mesh = make_mesh_2d(*grid, ("py", "px"), device_type=device_type)
    dA = Dist2DCSR.from_scipy(A, tuple(grid)).shard(mesh)
    return _numpy(dist2d_spmv_fn(dA, mesh, realign=realign)(
        rows_of(x, mesh, "px")))


def dist2d_cg(A, b, grid, tol=1e-6, max_iter=1000, device_type="cuda"):
    """CG over the realigned 2-D operator, dots summed over px (x's
    shards; the py copies are equal)."""
    from libhpc_tpu_torch.ops.solver import _cg
    from libhpc_tpu_torch.parallel.dist2d import Dist2DCSR, dist2d_spmv_fn
    from libhpc_tpu_torch.parallel.dist_spmv import global_dot

    mesh = make_mesh_2d(*grid, ("py", "px"), device_type=device_type)
    dA = Dist2DCSR.from_scipy(A, tuple(grid)).shard(mesh)
    matvec = dist2d_spmv_fn(dA, mesh, realign=True)
    return _solve_out(*_cg(matvec, rows_of(b, mesh, "px"), None, tol,
                           max_iter, global_dot("px", mesh)))


def sbell_spmv(A, x, device_type="cuda"):
    """This rank's y of the DistSBELL matvec (x padded to the partition)."""
    from libhpc_tpu_torch.parallel.dist_sbell import (DistSBELL,
                                                      dist_sbell_spmv_fn)

    mesh = make_mesh_1d(device_type=device_type)
    dA = DistSBELL.from_scipy(A, mesh.size()).shard(mesh)
    return _numpy(dist_sbell_spmv_fn(dA, mesh)(rows_of(x, mesh)))


def amg_pcg(A, b, tol=1e-6, max_iter=200, device_type="cuda", **kw):
    from libhpc_tpu_torch.parallel.dist_amg import dist_amg_pcg

    mesh = make_mesh_1d(device_type=device_type)
    return _solve_out(*dist_amg_pcg(A, mesh, mesh.size(), b, tol=tol,
                                    max_iter=max_iter, **kw))
