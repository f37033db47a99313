"""FarPane far-set contribution to an SBELL SpMV.

Port of ``libhpc_tpu/ops/far_pallas.py``: ``far_pane_out_panes`` launches
the far-only mode of the SpMV kernel ``csrc/sbell_spmv.cu`` (the port of
the Pallas ``far_pallas.py:_kernel``; ``spmv_sbell.sbell_spmv_panes`` runs
the same far set fused into its near launch), and
``far_pane_out_panes_torch`` is its plain PyTorch version, the port of
``far_pane_out_panes_xla``.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises. ``FAR_LAUNCHES`` counts far-only
launches.
"""

from __future__ import annotations

import torch

from libhpc_tpu_torch.ops._cuda_utils import kernel_device
from libhpc_tpu_torch.ops.spmv_sbell import MODE_FAR, check_far, launch
from libhpc_tpu_torch.sparse.sbell import B, LANE, FarPane

FAR_LAUNCHES = 0


def far_pane_out_panes_torch(fp: FarPane, x3: torch.Tensor,
                             guarded_rows: int) -> torch.Tensor:
    """Plain version: gather + 8-term product + one-hot product, all in
    lane-major layout. Returns ((n_stripes + W_PANES - 1) * B, LANE) f32
    rows of the near kernel's guarded output layout (guarded_rows)."""
    S, E = fp.ep.shape[0], fp.e_pad
    ep = fp.ep.long().clamp_min(0)
    g = x3[ep, :, fp.lidx.long()]                 # (S, LANE, B) [s,e,j]
    g = torch.where((fp.ep >= 0)[:, :, None], g, 0.0)
    bt = fp.bt.reshape(S, B, B, LANE).float()     # [s,j,i,e]
    prod = (bt * g.permute(0, 2, 1)[:, :, None, :]).sum(dim=1)  # [s,i,e]
    oh = fp.oh.reshape(S, E, LANE)
    out = torch.bmm(prod[:, :, :E], oh)           # [s,i,r]
    return out.reshape(S * B, LANE)[:guarded_rows]


def far_pane_out_panes(fp: FarPane, x3: torch.Tensor, guarded_rows: int
                       ) -> torch.Tensor:
    """Far contribution in the near kernel's guarded output layout
    ((n_stripes + W_PANES - 1) * B, LANE). x3 is the guarded pane array
    the near kernel consumes."""
    global FAR_LAUNCHES
    dev = kernel_device(fp.ep, fp.lidx, fp.bt, fp.oh, fp.olane, x3)
    if dev.type == "cpu":
        return far_pane_out_panes_torch(fp, x3, guarded_rows)
    S = fp.n_grouped
    if guarded_rows > S * B:
        raise ValueError(f"guarded_rows {guarded_rows} > {S * B}")
    check_far(fp, x3, dev)
    out = torch.empty((S * B, LANE), dtype=torch.float32, device=dev)
    launch(MODE_FAR, None, fp, x3, out, S)
    FAR_LAUNCHES += 1
    return out[:guarded_rows]
