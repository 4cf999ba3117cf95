"""Which kernel calls must carry a gradient, and the refusal for those
whose kernel has no backward.

A kernel wrapper hands back a tensor that the autograd graph knows
nothing of unless the wrapper itself defines the gradient.  ``flash_
attention`` and ``rmsnorm`` do (a ``torch.autograd.Function`` whose
backward launches a backward kernel, fp32 only); ``decode_attention``,
``paged_decode_attention`` and ``ssd_scan`` do not, so on any device but
the CPU (where the plain versions are differentiable PyTorch) they raise
rather than return an output whose gradient would silently be zero.
"""

from __future__ import annotations

import torch

# ROADMAP items that would give a kernel its backward
SSD_SCAN_BWD = "ROADMAP Queue 2, 'ssd_scan backward'"
BF16_BWD = "ROADMAP Queue 2, 'bf16 tensor-core backward kernels'"
DECODE_BWD = "decode kernels serve inference only: train through forward()"


def needs_grad(*tensors) -> bool:
    """True when grad mode is on and any of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse(name: str, why: str, *tensors) -> None:
    """Raise ``NotImplementedError`` for a call off the CPU that needs a
    gradient its kernel cannot give."""
    dev = next(t.device for t in tensors if t is not None)
    if dev.type != "cpu" and needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: no backward kernel on {dev.type} ({why}); train on "
            "the CPU or without this kernel")
