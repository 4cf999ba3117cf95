"""Hardware profiles for the cost model, Eq. 1 template sizing and the
roofline terms.

* ``H100_SXM``: the card the port serves on, an NVIDIA H100 SXM (80 GB).
  Its compute, memory and NVLink rates are the data sheet's.
  ``host_to_device_bw`` is the rate of a copy from pinned host memory to
  the card: the default is the data sheet's PCIe Gen5 x16 figure (64
  GB/s), and ``chip_smoke.py`` measures the real rate on the card it runs
  on and prints it (``with_h2d`` makes a profile that carries a measured
  rate).  Its fixed runtime costs (``context_create_s`` to
  ``copy_call_overhead_s``) are the paper's A6000 testbed values, not the
  H100's, until a measurement on the card replaces them.
* ``A6000_PCIE4`` and ``A100_PCIE3``: the paper's two testbeds, with the
  paper's own numbers, so that the cost model and the cluster scheduler
  can be held against the paper (and against the JAX package, whose
  scheduler defaults to ``A6000_PCIE4``).
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
    interconnect_bw: float      # bytes/s between cards (NVLink / PCIe)
    host_memory: float          # bytes per host
    storage_bw: float = 2e9     # bytes/s local NVMe (dynamic adapter loads)
    # achievable fractions of peak for the cost model (roofline terms use
    # the raw peaks); the paper's values, calibrated against its Fig. 17
    flops_eff: float = 0.45
    bw_eff: float = 0.85
    # fixed runtime costs (seconds): the paper's A6000 testbed values
    context_create_s: float = 0.5       # CUDA context creation
    kernel_cold_load_s: float = 0.180   # paper: ~180 ms lazy code-segment load
    prewarm_base_s: float = 0.830       # paper: process pre-warm 830 ms
    prewarm_tidal_s: float = 1.070      # paper: with proactive code loading
    fork_overhead_s: float = 0.010      # template-start fork (paper: <10 ms)
    copy_call_overhead_s: float = 10e-6  # per async-copy command issue

    def with_h2d(self, bytes_per_s: float) -> "HardwareProfile":
        """This profile with a measured host-to-device rate."""
        return dataclasses.replace(self, host_to_device_bw=float(bytes_per_s))


H100_SXM = HardwareProfile(
    name="h100-sxm",
    peak_flops_bf16=989e12,          # data sheet, dense
    hbm_bandwidth=3.35e12,           # data sheet, HBM3
    hbm_capacity=80e9,
    host_to_device_bw=64e9,          # data sheet: PCIe Gen5 x16, one way
    # data sheet: NVLink 4 at 900 GB/s in total per card, both directions
    # over all 18 links (not per link)
    interconnect_bw=900e9,
    host_memory=2 * 2**40,           # DGX H100 data sheet: 2 TB per host
)

# Paper testbed 1: 4 servers x (AMD EPYC 7R32 + 2x RTX A6000 48GB), PCIe 4.0.
A6000_PCIE4 = HardwareProfile(
    name="a6000-pcie4",
    peak_flops_bf16=155e12,          # A6000 BF16 w/ sparsity off (~155 TFLOP/s tensor)
    hbm_bandwidth=768e9,             # GDDR6 768 GB/s
    hbm_capacity=48 * 2**30,
    host_to_device_bw=32e9,          # PCIe 4.0 x16 (paper: 32 GB/s)
    interconnect_bw=32e9,            # no NVLink on testbed-1; PCIe p2p
    host_memory=512 * 2**30,
)

# Paper testbed 2: Intel Xeon 8369B + 8x A100 80GB, PCIe 3.0 (16 GB/s).
A100_PCIE3 = HardwareProfile(
    name="a100-pcie3",
    peak_flops_bf16=312e12,
    hbm_bandwidth=2039e9,
    hbm_capacity=80 * 2**30,
    host_to_device_bw=16e9,          # paper: PCIe 3.0, 16 GB/s
    interconnect_bw=16e9,
    host_memory=1024 * 2**30,
)

PROFILES = {p.name: p for p in (H100_SXM, A6000_PCIE4, A100_PCIE3)}


def get_profile(name: str) -> HardwareProfile:
    return PROFILES[name]
