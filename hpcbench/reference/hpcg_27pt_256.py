"""Plain reference of hpcg_27pt_256: the 27-point operator, matrix-free.

y = diagonal x + off_diagonal (sum of the 26 neighbours inside the grid),
as a 3 x 3 x 3 box sum of the zero-padded grid taken axis by axis, in any
dtype (float64 for the reference, bfloat16 for the control). It reads
only the grid's sizes and the two values; it builds no matrix.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def operator(inputs, dtype: torch.dtype, device):
    s = inputs.sizes
    nx, ny, nz = s["nx"], s["ny"], s["nz"]
    diag, off = s["diagonal"], s["off_diagonal"]

    def op(v: torch.Tensor) -> torch.Tensor:
        x = v.to(device=device, dtype=dtype).reshape(nz, ny, nx)
        p = F.pad(x, (1, 1, 1, 1, 1, 1))
        box = p[:, :, :-2] + p[:, :, 1:-1] + p[:, :, 2:]
        box = box[:, :-2] + box[:, 1:-1] + box[:, 2:]
        box = box[:-2] + box[1:-1] + box[2:]
        return (diag * x + off * (box - x)).reshape(-1)

    return op
