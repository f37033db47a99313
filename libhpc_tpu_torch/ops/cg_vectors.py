"""The vector work of one CG iteration: three steps that keep CG's scalars
in a per-solve state tensor.

``ops/solver.py:cg`` runs, after each matvec ``Ap = A p``:

  ``dot_pAp(p, Ap, ws)``          ws.pq = p . Ap
  ``update_xr(x, r, p, Ap, ws)``  alpha = rs / pq; x += alpha p;
                                  r -= alpha Ap; beta = (r . r) / rs;
                                  rs = r . r
  ``update_p(p, r, ws)``          p = r + beta p

x, r and p are updated in place. For CUDA tensors each step is one launch
of the hand-written kernels of ``csrc/cg_vectors.cu`` (``cg_dot_pAp``,
``cg_update_xr``, ``cg_update_p``), which read alpha and beta from the state
on the device; ``*_torch`` are their plain versions, the expressions and
order of the reference's loop (``libhpc_tpu/ops/solver.py:cg``), which CPU
tensors take. The kernels take float32 and float64 vectors of any
contiguous shape (the SBELL pane layout included); other dtypes raise.
``CG_VECTOR_LAUNCHES`` counts kernel launches: three an iteration.
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.ops._cuda_utils import (check_launch, check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)

CG_VECTOR_LAUNCHES = 0

# slots of Workspace.state (csrc/cg_vectors.cu kRs, kPq, kBeta)
RS, PQ, BETA = 0, 1, 2
N_SLOTS = 3
# partial sums a reduction may write: the kernels' grid is capped at it
MAX_BLOCKS = 1024

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class Workspace:
    """One solve's scalars and the kernels' scratch, on the vectors' device.

    ``state``: (N_SLOTS + MAX_BLOCKS,) in the vectors' dtype, rs, pq and
    beta first, then the blocks' partial sums; ``ticket``: one int32 the
    reductions count their finished blocks in, zero between launches;
    ``rs``: a view of the current r . r."""

    def __init__(self, r: torch.Tensor, rs):
        self.state = torch.empty(N_SLOTS + MAX_BLOCKS, dtype=r.dtype,
                                 device=r.device)
        self.state[RS] = rs
        self.ticket = torch.zeros(1, dtype=torch.int32, device=r.device)
        self.rs = self.state[RS]


def sdot(x, y):
    """The plain dot of every element: torch.sum(x * y)."""
    return torch.sum(x * y)


def dot_pAp_torch(p, Ap, ws: Workspace) -> None:
    ws.state[PQ] = sdot(p, Ap)


def update_xr_torch(x, r, p, Ap, ws: Workspace) -> None:
    rs = ws.state[RS].clone()
    alpha = rs / ws.state[PQ]
    x.copy_(x + alpha * p)
    r.copy_(r - alpha * Ap)
    rs_new = sdot(r, r)
    ws.state[BETA] = rs_new / rs
    ws.state[RS] = rs_new


def update_p_torch(p, r, ws: Workspace) -> None:
    p.copy_(r + ws.state[BETA] * p)


def _launch(name: str, dev: torch.device, vecs, ws: Workspace,
            reduces: bool) -> None:
    """Check the vectors and the workspace, and launch csrc/cg_vectors.cu's
    entry point `name` on them."""
    global CG_VECTOR_LAUNCHES
    dtype, shape = vecs[0].dtype, vecs[0].shape
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {dtype}, expected one of "
                        f"{tuple(_SUFFIX)}")
    for i, v in enumerate(vecs):
        check_tensor(v, f"{name} vector {i}", dev, (dtype,), shape)
    check_tensor(ws.state, "state", dev, (dtype,), (N_SLOTS + MAX_BLOCKS,))
    check_tensor(ws.ticket, "ticket", dev, (torch.int32,), (1,))
    n = vecs[0].numel()
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} elements, at most 2^31 - 1")
    ptrs = [v.data_ptr() for v in vecs] + [ws.state.data_ptr()]
    if reduces:
        ptrs += [ptrs[-1] + N_SLOTS * ws.state.element_size(),
                 ws.ticket.data_ptr()]
    fn = kernel_fn(f"{name}_{_SUFFIX[dtype]}", len(ptrs), 2)
    with torch.cuda.device(dev):
        rc = fn(*ptrs, n, MAX_BLOCKS, current_stream_ptr())
    check_launch(rc, name)
    CG_VECTOR_LAUNCHES += 1


def dot_pAp(p, Ap, ws: Workspace) -> None:
    """ws.state[PQ] = p . Ap."""
    dev = kernel_device(p, Ap, ws.state, ws.ticket)
    if dev.type == "cpu":
        return dot_pAp_torch(p, Ap, ws)
    _launch("cg_dot_pAp", dev, (p, Ap), ws, reduces=True)


def update_xr(x, r, p, Ap, ws: Workspace) -> None:
    """x += alpha p and r -= alpha Ap with alpha = rs / pq; then beta =
    (r . r) / rs and rs = r . r, in ws.state."""
    dev = kernel_device(x, r, p, Ap, ws.state, ws.ticket)
    if dev.type == "cpu":
        return update_xr_torch(x, r, p, Ap, ws)
    _launch("cg_update_xr", dev, (x, r, p, Ap), ws, reduces=True)


def update_p(p, r, ws: Workspace) -> None:
    """p = r + beta p, beta from ws.state."""
    dev = kernel_device(p, r, ws.state, ws.ticket)
    if dev.type == "cpu":
        return update_p_torch(p, r, ws)
    _launch("cg_update_p", dev, (p, r), ws, reduces=False)
