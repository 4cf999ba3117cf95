"""Kernel entry points the model layers call, and the launch counts.

Each entry point dispatches on where its tensors live: a CUDA tensor runs
the hand-written kernel (``csrc/``), a CPU tensor its plain PyTorch
version (``ref.py``), a ``meta`` tensor (tracing) an empty output of the
right shape (``meta.py``).  ``flash_attention`` and ``rmsnorm`` carry a
gradient when one is needed: their backward kernels count under
``flash_attention_bwd`` and ``rmsnorm_bwd``.  ``launch_counts`` reads how
often each kernel was launched, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
from repro_torch.kernels.ssd_scan import ssd_scan

KERNELS = {
    "decode_attention": decode_attention,
    "flash_attention": flash_attention,
    "flash_attention_bwd": flash_attention_bwd,
    "paged_decode_attention": paged_decode_attention,
    "rmsnorm": rmsnorm,
    "rmsnorm_bwd": rmsnorm_bwd,
    "ssd_scan": ssd_scan,
}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name, and under
    ``rmsnorm_fused`` the rmsnorm launches with the residual add fused in
    (counted under ``rmsnorm`` too)."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["rmsnorm_fused"] = rmsnorm.fused_launches
    return counts


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    rmsnorm.fused_launches = 0


__all__ = ["KERNELS", "decode_attention", "flash_attention",
           "flash_attention_bwd", "launch_counts", "paged_decode_attention",
           "reset_launch_counts", "rmsnorm", "rmsnorm_bwd", "ssd_scan"]
