"""The yardstick of the kernels: published peaks and the work of a call.

The work is counted from the matrix, not from a format's layout, so a
later kernel or format reads against the same count: a sparse
matrix-vector product y = A x reads each nonzero of the matrix once and x
once, and writes y once. Indices and a format's padding are left out (DIA
stores no index; 8 x 8 blocks store one for 64 values).
"""

from __future__ import annotations

# NVIDIA's data sheet (H100 SXM): HBM bandwidth and the float32 rate
# outside the tensor cores, at the full power limit of 700 W, by the name
# torch.cuda.get_device_name() gives
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}


def peak(device_kind: str) -> dict | None:
    """The published peaks of the card, or None for a card not listed."""
    return PEAKS.get(device_kind)


def spmv_bytes(nnz: int, m: int, n: int, value_bytes: int = 4,
               vector_bytes: int = 4) -> int:
    """Bytes of y = A x: every value read once, x read once, y written
    once."""
    return nnz * value_bytes + (m + n) * vector_bytes


def spmv_flops(nnz: int) -> int:
    """One multiply and one add a stored value."""
    return 2 * nnz


def spmv_least_seconds(nnz: int, m: int, n: int, device_kind: str
                       ) -> float | None:
    """The least time the card could take for y = A x: the larger of its
    bytes over the bandwidth and its operations over the float32 rate."""
    p = peak(device_kind)
    if p is None:
        return None
    return max(spmv_bytes(nnz, m, n) / p["hbm_bytes_per_s"],
               spmv_flops(nnz) / p["fp32_flops_per_s"])
