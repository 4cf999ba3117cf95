"""The serving card's profile, for the template's Eq. 1 sizing.

One profile: an NVIDIA H100 SXM (80 GB).  The compute and memory rates are
the data sheet's dense peaks.  ``host_to_device_bw`` is the rate of a
copy from pinned host memory to the card: the default below is the data
sheet's PCIe Gen5 x16 figure (64 GB/s), and ``chip_smoke.py`` measures
the real rate on the card it runs on and prints it (``with_h2d`` makes a
profile that carries a measured rate).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops_bf16: float      # FLOP/s, dense tensor-core bf16
    hbm_bandwidth: float        # bytes/s
    hbm_capacity: float         # bytes
    host_to_device_bw: float    # bytes/s, pinned host -> device copies

    def with_h2d(self, bytes_per_s: float) -> "HardwareProfile":
        """This profile with a measured host-to-device rate."""
        return dataclasses.replace(self, host_to_device_bw=float(bytes_per_s))


H100_SXM = HardwareProfile(
    name="h100-sxm",
    peak_flops_bf16=989e12,          # data sheet, dense
    hbm_bandwidth=3.35e12,           # data sheet, HBM3
    hbm_capacity=80e9,
    host_to_device_bw=64e9,          # data sheet: PCIe Gen5 x16, one way
)
