"""Runtime tracing of inference: weight access order and kernel set (TIDAL
§4.1, Figure 10 right).

TIDAL hooks PyTorch's dispatcher to observe, at runtime, (a) the order in
which weight tensors are consumed by kernels and (b) which kernels are
launched.  This module is that mechanism: a ``TorchDispatchMode`` over the
model's parameters as ``meta`` tensors (``Model.param_specs``), so a trace
touches no device memory and takes no card time.

  * every parameter tensor carries a label, its path
    (``layers.3.attn.wq``);
  * every aten op the entry point dispatches is seen in execution order;
    the first op that consumes a labelled tensor records an access;
  * labels flow through pure layout ops (``view``, ``reshape``,
    ``transpose``, ``permute``, ...) without recording an access: those
    touch metadata only, the bytes are needed at the first compute op.
    A tied embedding is therefore accessed FIRST (by the embedding
    lookup), not where it was initialized (the paper's Fig. 20 case);
  * every op's (name, shape signature) goes into the kernel set, the
    deduplicated set proactive code loading warms (§5.1); identical
    blocks contribute one block's worth of signatures;
  * the hand-written kernels do not run on ``meta`` tensors: their
    wrappers report themselves under their own names
    (``kernels.meta``) and return an empty output of the right shape.

Keys are ``(path, ())``: the port keeps one tensor per layer, so the
per-layer granularity the JAX tracer gets by expanding ``scan`` bodies is
here by construction.  ``convert.jax_key`` maps a key to the JAX
package's ``('blocks.attn.wq', (3,))``; the two orders agree key for key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import meta
from repro_torch.utils import named_leaves, tensor_nbytes

# A weight key: (param path, ()) — one tensor per layer in the port.
WeightKey = tuple

# layout-only ops: the label flows to the output, no access recorded
TRANSPARENT = frozenset({
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute", "expand",
    "unsqueeze", "squeeze", "alias", "detach"})


@dataclasses.dataclass
class AccessTrace:
    order: list                    # list[WeightKey] in first-use order
    kernels: set                   # deduped (op name, shape signature)
    kernel_launches: int           # ops executed (kernel calls included)
    n_params_seen: int

    def key_set(self) -> set:
        return set(self.order)


def _sig(tensors) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                 for t in tensors)


class _AccessMode(TorchDispatchMode):
    """Records first-use order of labelled tensors and the op set."""

    def __init__(self, labels: dict):
        super().__init__()
        # id -> (tensor, label); the tensor is held so its id stays unique
        self.labels = labels
        self.order: list = []
        self.seen: set = set()
        self.kernels: set = set()
        self.launches = 0
        self.quiet = 0                 # > 0 inside a kernel wrapper

    def _label(self, t):
        entry = self.labels.get(id(t))
        return entry[1] if entry is not None and entry[0] is t else None

    def _access(self, label: str) -> None:
        if label not in self.seen:
            self.seen.add(label)
            self.order.append((label, ()))

    def kernel(self, name: str, inputs: tuple) -> None:
        """A hand-written kernel called on meta tensors (``kernels.meta``)."""
        self.launches += 1
        self.kernels.add((name, _sig(inputs)))
        for t in inputs:
            label = self._label(t)
            if label is not None:
                self._access(label)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.quiet:
            return out
        name = func.overloadpacket.__name__
        flat, _ = tree_flatten((args, kwargs))
        tensors = [a for a in flat if isinstance(a, torch.Tensor)]
        self.launches += 1
        self.kernels.add((name, _sig(tensors)))
        labels = [lab for lab in map(self._label, tensors) if lab is not None]
        if name in TRANSPARENT and len(labels) == 1 and isinstance(
                out, torch.Tensor):
            self.labels[id(out)] = (out, labels[0])
            return out
        for label in labels:
            self._access(label)
        return out


def trace_weight_access(fn: Callable, params, *rest) -> AccessTrace:
    """Trace ``fn(params, *rest)`` and extract the weight access order.

    ``params`` is a nested dict/list of ``meta`` tensors (zero device
    work); ``rest`` are traced but not labelled."""
    labels = {id(t): (t, path) for path, t in named_leaves(params)}
    mode = _AccessMode(labels)
    meta.add_observer(mode)
    try:
        with torch.no_grad(), mode:
            fn(params, *rest)
    finally:
        meta.remove_observer(mode)
    return AccessTrace(order=list(mode.order), kernels=set(mode.kernels),
                       kernel_launches=mode.launches,
                       n_params_seen=len(mode.order))


# ---------------------------------------------------------------------------
# weight size accounting (per WeightKey, for streaming schedules)
# ---------------------------------------------------------------------------

def weight_sizes(params, order: Sequence[WeightKey]) -> dict:
    """Bytes per WeightKey."""
    by_path = dict(named_leaves(params))
    return {key: tensor_nbytes(by_path[key[0]]) for key in order}


def coverage(params, trace: AccessTrace) -> tuple:
    """(accessed paths, missed paths): a missed weight would never be
    streamed."""
    all_paths = {path for path, _ in named_leaves(params)}
    got = {p for p, _ in trace.order}
    return got, all_paths - got



def total_order_bytes(params, trace: AccessTrace) -> int:
    return sum(weight_sizes(params, trace.order).values())
