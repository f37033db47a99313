"""SBELL SpMV — the main path's matrix-vector product.

Port of ``libhpc_tpu/ops/spmv_pallas.py`` (``x_to_panes``, ``panes_to_x``,
``sbell_spmv_panes``, ``sbell_spmv_padded``, ``sbell_spmv``). One
hand-written CUDA kernel, ``csrc/sbell_spmv.cu``, serves the whole product
in three launch modes (``launch``):

  near only  ``near_out_panes``: the port of both Pallas near kernels
    (``spmv_pallas.py:_kernel`` and ``:_ranged_kernel``);
    ``near_out_panes_torch`` is its plain PyTorch version.
  far only   ``far_sbell.far_pane_out_panes``: the port of
    ``far_pallas.py:_kernel`` (a FarPane far set).
  fused      ``sbell_spmv_panes`` on a FarPane far set or none: near and
    far in one launch a matvec, into an output it writes whole.
A flat FarBlocks far set takes the near launch plus the plain
``spmv.far_spmv``, as the reference's goes through XLA.

The reference splits the near path into an x-resident and a row-chunked
kernel because x and the output had to fit the TPU's VMEM; the Hopper
kernel reads x from global memory, so the port has one path and runs no
chunk plan. The reference's host planner (``VMEM_CAP``,
``_resident_bytes``, ``_worst_chunk_bytes``, ``_chunk_plan``) is kept,
numpy line for line, only so that ``parallel.dist_sbell.DistSBELL``
carries the reference's chunk statics and bounds; the kernel ignores them.
One CTA takes a stripe and streams its tiles through a ring of
shared-memory stages. The wrappers run the plain versions for CPU tensors
only; for CUDA tensors they launch the kernel or raise.
``NEAR_LAUNCHES`` counts near-only launches, ``SPMV_LAUNCHES`` fused ones
(``far_sbell.FAR_LAUNCHES`` far-only ones). While a profiler records,
``sbell_spmv_padded``'s pane layout (``x_to_panes``) is a
``libhpc.spmv.prepare`` range and ``sbell_spmv_panes`` a
``libhpc.spmv.launch`` range (``utils/profiling.annotate``).
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.ops._cuda_utils import (check_launch, check_tensor,
                                              current_stream_ptr,
                                              kernel_device, kernel_fn)
from libhpc_tpu_torch.sparse.sbell import (B, LANE, PANE_COLS, SBELL, VROWS,
                                           W_PANES, FarPane)
from libhpc_tpu_torch.utils.profiling import (SPMV_LAUNCH, SPMV_PREPARE,
                                              annotate)

NEAR_LAUNCHES = 0
SPMV_LAUNCHES = 0

MODE_NEAR, MODE_FAR, MODE_BOTH = 1, 2, 3

# the reference's VMEM budget of its x-resident kernel (bytes): its
# defaults (LIBHPC_SBELL_VMEM_LIMIT = 100 MB, cap = limit - 4 MB), kept as
# constants with no environment read; they decide DistSBELL's chunk plans
VMEM_LIMIT = 100 * 1024 * 1024
VMEM_CAP = VMEM_LIMIT - 4 * 1024 * 1024


def _resident_bytes(n_stripes: int, n_panes: int) -> int:
    """VMEM the reference's resident x panes + output take for one call."""
    return ((n_panes + W_PANES - 1) * B * LANE + n_stripes * B * LANE) * 4


def _worst_chunk_bytes(sid_np, pane_np, n_stripes: int, spc: int):
    """(worst-group VMEM bytes, worst group index) for stripe groups of
    size spc: per-group pane window + double-buffered output slice."""
    n_grp = -(-n_stripes // spc)
    worst, worst_g = 0, 0
    for g in range(n_grp):
        s_lo, s_hi = g * spc, min((g + 1) * spc, n_stripes)
        sel = (sid_np >= s_lo) & (sid_np < s_hi)
        if sel.any():
            win = int(pane_np[sel].max() - pane_np[sel].min()) + W_PANES
        else:
            win = W_PANES
        need = (win + 2 * (spc + W_PANES - 1)) * B * LANE * 4
        if need > worst:
            worst, worst_g = need, g
    return worst, worst_g


def _chunk_plan(sb: SBELL, force_spc: int | None = None):
    """The reference's host stripe grouping, so each group fits VMEM_CAP.

    Returns (stripes_per_chunk, win_panes, gsteps, bounds), bounds a tuple
    of (g0, stripe_lo, pane_lo) per group. force_spc pins the stripes per
    chunk (parallel/dist_sbell.py needs one value across shards)."""
    import numpy as np

    pane_np = sb.pane.cpu().numpy()
    sid_np = sb.sid.cpu().numpy()
    # real tiles are stripe-major; the tpb padding tail restarts at sid 0
    dec = np.flatnonzero(np.diff(sid_np.astype(np.int64)) < 0)
    n_true = int(dec[-1]) + 1 if dec.size else len(sid_np)
    sid_np = sid_np[:n_true]
    pane_np = pane_np[:n_true]

    if force_spc is not None:
        spc = force_spc
    else:
        spc = sb.n_stripes
        while True:
            worst, worst_g = _worst_chunk_bytes(sid_np, pane_np,
                                                sb.n_stripes, spc)
            if worst <= VMEM_CAP:
                break
            if spc == 1:
                raise ValueError(
                    f"sbell_spmv: stripe {worst_g} alone needs {worst} B "
                    f"of VMEM (pane window + output) but VMEM_CAP is "
                    f"{VMEM_CAP} B; the matrix is too wide-scattered for "
                    "the chunked near kernel")
            spc //= 2
    n_grp = -(-sb.n_stripes // spc)
    G = sb.n_tiles // sb.tpb
    win_panes = W_PANES
    raw = []
    for g in range(n_grp):
        s_lo, s_hi = g * spc, min((g + 1) * spc, sb.n_stripes)
        sel = (sid_np >= s_lo) & (sid_np < s_hi)
        if sel.any():
            t0, t1 = int(np.flatnonzero(sel)[0]), int(
                np.flatnonzero(sel)[-1]) + 1
            p_lo = int(pane_np[sel].min())
            win_panes = max(win_panes,
                            int(pane_np[sel].max()) - p_lo + W_PANES)
        else:
            t0 = t1 = 0
            p_lo = 0
        raw.append((t0, t1, s_lo, p_lo))
    tpb = sb.tpb
    gsteps = max((-(-t1 // tpb)) - (t0 // tpb)
                 for t0, t1, _, _ in raw) or 1
    gsteps = min(gsteps, G)
    bounds = []
    for (t0, t1, s_lo, p_lo) in raw:
        g0 = min(max(t0 // tpb, 0), G - gsteps)
        bounds.append((g0, s_lo, p_lo))
    return (spc, win_panes, gsteps, tuple(bounds))


def _check_aligned(t: torch.Tensor, name: str) -> None:
    """The kernel's bulk copies and x gathers need 16-byte aligned bases."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def check_near(sb: SBELL, x3: torch.Tensor, dev: torch.device) -> None:
    T, S = sb.n_tiles, sb.n_stripes
    check_tensor(sb.vflat, "vflat", dev, (torch.float32, torch.bfloat16),
                 (T * VROWS, LANE))
    check_tensor(sb.meta, "meta", dev, (torch.int32,), (T, LANE))
    check_tensor(sb.pane, "pane", dev, (torch.int32,), (T,))
    check_tensor(sb.tile_ptr, "tile_ptr", dev, (torch.int32,), (S + 1,))
    check_tensor(x3, "x3", dev, (torch.float32,),
                 (sb.n_panes + W_PANES - 1, B, LANE))
    for t, name in ((sb.vflat, "vflat"), (sb.meta, "meta"), (x3, "x3")):
        _check_aligned(t, name)


def check_far(fp: FarPane, x3: torch.Tensor, dev: torch.device) -> None:
    S, E = fp.n_grouped, fp.e_pad
    if not 0 < E <= LANE or E % 4:
        raise ValueError(f"e_pad {E}: the kernel takes a multiple of 4 in "
                         f"4..{LANE}")
    for t, name in ((fp.ep, "ep"), (fp.lidx, "lidx"), (fp.olane, "olane")):
        check_tensor(t, name, dev, (torch.int32,), (S, LANE))
    check_tensor(fp.bt, "bt", dev, (torch.float32, torch.bfloat16),
                 (S * VROWS, LANE))
    n_panes = fp.shape[1] // PANE_COLS
    check_tensor(x3, "x3", dev, (torch.float32,),
                 (n_panes + W_PANES - 1, B, LANE))
    _check_aligned(x3, "x3")


def launch(mode: int, sb: SBELL | None, fp: FarPane | None,
           x3: torch.Tensor, out: torch.Tensor, n_out: int) -> None:
    """One launch of csrc/sbell_spmv.cu on checked CUDA tensors: `mode`
    (MODE_NEAR, MODE_FAR, MODE_BOTH) over n_out stripes of `out`, one CTA a
    stripe. This counts nothing."""
    vals = sb.vflat if sb is not None else fp.bt
    if fp is not None and sb is not None and fp.bt.dtype != sb.vflat.dtype:
        raise TypeError(f"far values {fp.bt.dtype} and near values "
                        f"{sb.vflat.dtype} differ")
    name = ("sbell_spmv_f32" if vals.dtype == torch.float32
            else "sbell_spmv_bf16")
    fn = kernel_fn(name, 10, 5)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    near = (sb.vflat, sb.meta, sb.pane, sb.tile_ptr) if sb is not None \
        else (None,) * 4
    far = (fp.ep, fp.lidx, fp.bt, fp.olane) if fp is not None \
        else (None,) * 4
    with torch.cuda.device(out.device):
        rc = fn(*map(ptr, near), x3.data_ptr(), *map(ptr, far),
                out.data_ptr(), n_out, sb.n_stripes if sb is not None else 0,
                fp.e_pad if fp is not None else 0,
                sb.k_max if sb is not None else 0, mode,
                current_stream_ptr())
    check_launch(rc, name)


def _near_launch(sb: SBELL, fp: FarPane | None, x3: torch.Tensor,
                 dev: torch.device) -> torch.Tensor:
    """Near (fp None) or fused launch into a new output."""
    S = sb.n_stripes + W_PANES - 1
    out = torch.empty((S * B, LANE), dtype=torch.float32, device=dev)
    launch(MODE_BOTH if fp is not None else MODE_NEAR, sb, fp, x3, out, S)
    return out


def near_out_panes_torch(sb: SBELL, x3: torch.Tensor) -> torch.Tensor:
    """Plain version of the near kernel: ((n_stripes + W_PANES - 1) * B,
    LANE) f32 with out[8 sid + i, slot] += sum_j V[8j+i, slot] * x_j[slot]
    over every tile; the guard stripes stay zero."""
    T = sb.n_tiles
    v = sb.vflat.reshape(T, B, B, LANE).float()          # [t, j, i, slot]
    m = sb.meta.long()
    p = sb.pane.long()[:, None] + (m >> 7)               # (T, LANE)
    gx = x3[p, :, m & (LANE - 1)]                        # (T, LANE, B)
    prod = (v * gx.permute(0, 2, 1)[:, :, None, :]).sum(dim=1)  # [t,i,slot]
    out = torch.zeros((sb.n_stripes + W_PANES - 1, B, LANE),
                      dtype=torch.float32, device=x3.device)
    out.index_add_(0, sb.sid.long(), prod)
    return out.reshape(-1, LANE)


def near_out_panes(sb: SBELL, x3: torch.Tensor) -> torch.Tensor:
    """Near-tile product in the guarded output layout ((n_stripes +
    W_PANES - 1) * B, LANE) f32; x3 is the guarded pane array."""
    global NEAR_LAUNCHES
    dev = kernel_device(sb.vflat, sb.meta, sb.pane, sb.tile_ptr, x3)
    if dev.type == "cpu":
        return near_out_panes_torch(sb, x3)
    check_near(sb, x3, dev)
    out = _near_launch(sb, None, x3, dev)
    NEAR_LAUNCHES += 1
    return out


def x_to_panes(sb: SBELL, xpad: torch.Tensor) -> torch.Tensor:
    """Padded flat x -> GUARDED pane layout (n_panes + W_PANES - 1, 8,
    128): x3[p, j, l] = x[1024 p + 8 l + j], trailing guard panes zero."""
    x3 = xpad.reshape(sb.n_panes, LANE, B).transpose(1, 2)
    guard = x3.new_zeros((W_PANES - 1, B, LANE))
    return torch.cat([x3, guard])


def panes_to_x(sb: SBELL, out3: torch.Tensor) -> torch.Tensor:
    """Guarded kernel-output pane layout -> padded flat y."""
    return out3[:sb.n_stripes].transpose(1, 2).reshape(-1)


def sbell_spmv_panes(sb: SBELL, x3: torch.Tensor, chunk_plan=None
                     ) -> torch.Tensor:
    """y = A @ x entirely in GUARDED pane layout: x3 is
    (n_panes + W_PANES - 1, 8, 128) with x3[p, j, l] = x[1024 p + 8 l + j]
    and zero guard panes at the end; the result
    (n_stripes + W_PANES - 1, 8, 128) follows the SAME convention over y,
    so for square matrices it feeds the next matvec directly. Iterative
    solvers keep vectors in this layout across iterations.

    On the card a FarPane far set (or none) makes one fused launch; flat
    FarBlocks add the plain far_spmv to the near launch. chunk_plan is
    accepted for signature parity with the reference and unused: the
    Hopper kernel reads x from global memory, so there is no
    resident/chunked split."""
    global SPMV_LAUNCHES
    with annotate(SPMV_LAUNCH):
        fused = sb.far is None or isinstance(sb.far, FarPane)
        if fused and x3.device.type == "cuda":
            fp = sb.far
            leaves = (sb.vflat, sb.meta, sb.pane, sb.tile_ptr, x3)
            if fp is not None:
                leaves += (fp.ep, fp.lidx, fp.bt, fp.olane)
            dev = kernel_device(*leaves)
            check_near(sb, x3, dev)
            if fp is not None:
                check_far(fp, x3, dev)
                if fp.n_grouped < sb.n_stripes + W_PANES - 1:
                    raise ValueError(f"far set of {fp.n_grouped} grouped "
                                     f"stripes for {sb.n_stripes} stripes")
            out = _near_launch(sb, fp, x3, dev)
            SPMV_LAUNCHES += 1
            return out.reshape(sb.n_stripes + W_PANES - 1, B, LANE)
        out = near_out_panes(sb, x3)
        if isinstance(sb.far, FarPane):
            from libhpc_tpu_torch.ops.far_sbell import far_pane_out_panes

            guarded = (sb.n_stripes + W_PANES - 1) * B
            out = out + far_pane_out_panes(sb.far, x3, guarded)
        elif sb.far is not None:
            from libhpc_tpu_torch.ops.spmv import far_spmv

            xflat = x3[:sb.n_panes].transpose(1, 2).reshape(-1)
            yfar = far_spmv(sb.far, xflat)
            yfar = yfar.reshape(sb.n_stripes, LANE, B).transpose(
                1, 2).reshape(sb.n_stripes * B, LANE)
            out[:sb.n_stripes * B] += yfar
        return out.reshape(sb.n_stripes + W_PANES - 1, B, LANE)


def sbell_spmv_padded(sb: SBELL, xpad: torch.Tensor, chunk_plan=None
                      ) -> torch.Tensor:
    """y = A @ x in the PADDED domain: xpad is (n_panes*1024,) f32 and the
    result has n_stripes*1024 entries (zero pad rows/cols are inert)."""
    with annotate(SPMV_PREPARE):
        x3 = x_to_panes(sb, xpad)
    return panes_to_x(sb, sbell_spmv_panes(sb, x3, chunk_plan))


def sbell_spmv(sb: SBELL, x: torch.Tensor, chunk_plan=None) -> torch.Tensor:
    """y = A @ x for SBELL A. x is f32 (ncols,); returns f32 (nrows,)."""
    m, n = sb.shape
    xpad = torch.nn.functional.pad(x, (0, sb.n_panes * PANE_COLS - n))
    return sbell_spmv_padded(sb, xpad, chunk_plan)[:m]
