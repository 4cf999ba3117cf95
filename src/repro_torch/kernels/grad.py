"""Which kernel calls must carry a gradient, and the refusal for those
whose kernel has no backward.

A kernel wrapper hands back a tensor that the autograd graph knows
nothing of unless the wrapper itself defines the gradient.
``flash_attention``, ``rmsnorm`` (whole-row and split-row) and
``ssd_scan`` do (a ``torch.autograd.Function`` whose backward launches a
backward kernel, fp32 only); ``decode_attention`` and
``paged_decode_attention`` do not, so on any device but the CPU (where
the plain versions are differentiable PyTorch) they raise rather than
return an output whose gradient would silently be zero.
"""

from __future__ import annotations

import torch

# the ROADMAP item that would give the bf16 calls their backward kernels
BF16_BWD = "ROADMAP Queue 2, item 7, 'bf16 tensor-core backward kernels'"
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
