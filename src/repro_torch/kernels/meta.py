"""Shape-only kernel calls on the ``meta`` device, for tracing.

``core.tracing`` traces a model over ``meta`` tensors, which have shapes
and dtypes but no storage.  A kernel wrapper that receives a ``meta``
tensor neither launches its CUDA kernel nor runs its plain version: it
calls :func:`kernel_call`, which tells every active observer that the
kernel ran (its name and input signature enter the traced kernel set) and
returns an empty output of the right shape.  Nothing here runs outside a
trace.
"""

from __future__ import annotations

from typing import Callable

import torch

_observers: list = []


def is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def kernel_call(name: str, inputs: tuple, make_out: Callable):
    """Report one kernel call to the observers; return ``make_out()``.

    Observers have ``kernel(name, inputs)`` and a ``quiet`` depth: while
    the output is allocated their own op recording is paused, so the
    allocation does not enter the kernel set beside the kernel itself."""
    for obs in _observers:
        obs.kernel(name, inputs)
        obs.quiet += 1
    try:
        return make_out()
    finally:
        for obs in _observers:
            obs.quiet -= 1


def add_observer(obs) -> None:
    _observers.append(obs)


def remove_observer(obs) -> None:
    _observers.remove(obs)
