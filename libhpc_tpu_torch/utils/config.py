"""Static configuration dataclasses.

Port of ``libhpc_tpu/utils/config.py`` (``KernelConfig``, ``RadixConfig``).
libHPC configures everything at compile time through template parameters
(e.g. BinSize restricted to {16, 256, 65536} in
lib/sort/radix_cpu/include/radix_sort_cpu.hpp:26-31); the reference
expresses them as frozen dataclasses. The port keeps the same fields and
the same validation rules, so the same inputs raise: ``lane`` stays the
TPU's 128, which is also the row width of the port's K20 / K21 probes.
"""

from __future__ import annotations

import dataclasses


def _check_pow2(name: str, v: int) -> None:
    if v <= 0 or (v & (v - 1)) != 0:
        raise ValueError(f"{name} must be a positive power of two, got {v}")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Tiling parameters: power-of-two tiles, lane width 128."""

    tile_m: int = 256
    tile_n: int = 256
    lane: int = 128

    def __post_init__(self):
        _check_pow2("tile_m", self.tile_m)
        _check_pow2("tile_n", self.tile_n)
        if self.lane != 128:
            raise ValueError("TPU lane width is 128")


@dataclasses.dataclass(frozen=True)
class RadixConfig:
    """Radix sort configuration: libHPC's allowed BinSize set {16, 256,
    65536} (radix_sort_cpu.hpp:26-31) as bits per pass."""

    bits_per_pass: int = 8

    def __post_init__(self):
        if self.bits_per_pass not in (4, 8, 16):
            raise ValueError("bits_per_pass must be one of {4, 8, 16}")

    @property
    def n_bins(self) -> int:
        return 1 << self.bits_per_pass

    @property
    def n_passes(self) -> int:
        return (32 + self.bits_per_pass - 1) // self.bits_per_pass
