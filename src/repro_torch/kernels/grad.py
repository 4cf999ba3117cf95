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

The backward kernels take fp32 only.  A bf16 call that needs a gradient
raises off the CPU (``meta`` standing in for the card); inside
:func:`noting_card_lacks` (the dry run's shape-only trace) a ``meta`` call
goes on by its shapes instead and :func:`refuse_bf16` records the
backward kernel the card lacks.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

# the ROADMAP item that would give the bf16 calls their backward kernels
BF16_BWD = "ROADMAP Queue 2, item 7, 'bf16 tensor-core backward kernels'"
DECODE_BWD = "decode kernels serve inference only: train through forward()"

# the backward kernels a meta trace went past that the card would refuse
_LACKS: contextvars.ContextVar = contextvars.ContextVar("card_lacks",
                                                        default=None)


@contextlib.contextmanager
def noting_card_lacks():
    """Scope of a shape-only trace: bf16 gradients on ``meta`` go on by
    their shapes; yields the set of backward kernels they needed."""
    lacks: set = set()
    token = _LACKS.set(lacks)
    try:
        yield lacks
    finally:
        _LACKS.reset(token)


def refuse_bf16(name: str, message: str, t: torch.Tensor) -> None:
    """Raise ``NotImplementedError(message)`` for a bf16 gradient off the
    CPU; a ``meta`` call inside :func:`noting_card_lacks` records ``name``
    instead."""
    lacks = _LACKS.get()
    if t.device.type == "meta" and lacks is not None:
        lacks.add(name)
        return
    raise NotImplementedError(message)


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
