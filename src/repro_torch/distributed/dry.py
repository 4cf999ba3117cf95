"""One rank of a large mesh in one process: the dry run's process group
and its memory reckoning (the port's counterpart of the reference's
512 placeholder host devices and XLA's ``memory_analysis``).

:func:`fake_world` sets up torch's ``fake`` backend as the default
process group for ``world`` ranks, of which this process is rank 0: every
collective returns at once and moves no data, over ``meta`` tensors
(nothing runs) or over tensors on a card (one rank of a cell, whose
values are not checked).  :func:`rank_plan` gives the plan of one rank
of a (data, model) mesh under it, with the process groups the rank's
collectives name.  The group is torn down when the ``with`` block ends,
so that no default group outlives a cell.

:class:`LiveBytes` is a ``TorchDispatchMode`` that counts the bytes of
the storages a step allocates (a view shares its base's storage and
counts nothing): the peak of the live bytes above the step's arguments,
and the bytes its outputs hold.  On ``meta`` it reckons the step's
memory without running it; on a card ``torch.cuda.max_memory_allocated``
reads the same quantity.

Inside :func:`peak_bytes` a recurrence over ``meta`` tensors (the
xLSTM's sLSTM time loop and mLSTM chunk loop, ``models.ssm.scan``) runs
its steps in groups (:func:`grouped_scan`): the same ops on a group of
steps at once, the same shapes out, the same bytes kept for the
backward, in about ``RECKON_GROUPS`` iterations instead of one per
step.  A meta op costs ~0.2 ms of host time, and xlstm-1.3b's prefill
of 32,768 tokens would run ~3 M of them step by step; the cost is a
transient per group, a group's temporaries at once instead of one
step's.  Tensors on a device never take this path.
"""

from __future__ import annotations

import contextlib
from typing import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import ServingMesh, ShardingPlan


@contextlib.contextmanager
def fake_world(world: int):
    """The default process group as rank 0 of ``world`` under the
    ``fake`` backend, destroyed on exit; raises when a default group
    already exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists: the "
                           "dry run needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank_plan(data: int, model: int, training: bool = False,
              fsdp: bool = False, mode: str = "tp",
              prefer_seq: bool = False) -> ShardingPlan:
    """The plan of global rank 0 of a (``data``, ``model``) mesh inside
    :func:`fake_world`: a training plan over the whole mesh, or the
    serving plan of its data slice (the reference's serving cells place
    the batch over 'data' too: each slice serves its rows)."""
    import torch.distributed as dist
    group = dist.new_group(list(range(model)))
    if not training:
        return ShardingPlan(ServingMesh(1, model), group=group,
                            prefer_seq=prefer_seq)
    axis = dist.new_group([d * model for d in range(data)])
    return sharding.training_plan(ServingMesh(data, model), group=group,
                                  data_group=axis,
                                  world_group=dist.group.WORLD, fsdp=fsdp,
                                  mode=mode)


def storages(tree) -> Iterable:
    """The storages of the tensors in ``tree`` (a nested dict / list)."""
    from torch.multiprocessing.reductions import StorageWeakRef
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            yield StorageWeakRef(s), s.nbytes()


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages ops allocate while the mode is on.

    ``args`` (the step's inputs: parameters, state, cache, batch) are
    counted once in ``arg_bytes`` and never as new.  ``peak`` is the
    largest sum of the live new storages after any op (the peak above
    the arguments); :meth:`output_bytes` the new storages a result still
    holds.  A storage freed is found by its weak reference: the live sum
    (which counts freed storages until a scan finds them) is made exact
    whenever it would pass the peak by more than ``slack`` (1/512 of the
    peak, at least 64 KiB), so ``peak`` is exact to within that.  A scan
    after every op that passes the peak would be quadratic in the live
    storages: an xLSTM prefill of 32,768 tokens keeps every sLSTM step's
    output alive until the stack."""

    def __init__(self, args=None):
        super().__init__()
        self.args = dict(storages(args)) if args is not None else {}
        self.arg_bytes = sum(self.args.values())
        self.new: dict = {}
        self.live = 0
        self.peak = 0

    @property
    def slack(self) -> int:
        return max(self.peak >> 9, 1 << 16)

    def _purge(self) -> None:
        dead = [r for r in self.new if r.expired()]
        for r in dead:
            self.live -= self.new.pop(r)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for ref, nbytes in storages(out):
            if ref not in self.args and ref not in self.new:
                self.new[ref] = nbytes
                self.live += nbytes
        if self.live > self.peak + self.slack:
            self._purge()
            self.peak = max(self.peak, self.live)
        return out

    def output_bytes(self, result) -> int:
        """Bytes of the new storages ``result`` holds."""
        return sum(n for ref, n in dict(storages(result)).items()
                   if ref not in self.args)


RECKON_GROUPS = 64


def grouped_scan(step, xs: tuple, state: tuple) -> tuple:
    """``models.ssm.scan``'s stand-in over ``meta`` tensors: the steps in
    about ``RECKON_GROUPS`` groups, each group's steps side by side in
    the batch axis, every one from the group's first state (values do
    not matter on ``meta``; shapes and the bytes held do)."""
    B, T = xs[0].shape[:2]
    g = -(-T // RECKON_GROUPS)
    ys = []
    for a in range(0, T, g):
        n = min(g, T - a)

        def fold(t):
            return t[:, a:a + n].reshape((B * n,) + tuple(t.shape[2:]))

        def spread(t):
            return t[:, None].expand((B, n) + tuple(t.shape[1:])).reshape(
                (B * n,) + tuple(t.shape[1:]))

        y, out = step(*map(fold, xs), *map(spread, state))
        ys.append(y.reshape((B, n) + tuple(y.shape[1:])))
        state = tuple(t.reshape((B, n) + tuple(t.shape[1:]))[:, -1]
                      for t in out)
    return torch.cat(ys, dim=1), state


def peak_bytes(fn, args) -> tuple:
    """Run ``fn()`` under :class:`LiveBytes` over ``args``; returns its
    result and the reckoning ``{'argument_bytes', 'peak_above_arguments',
    'output_bytes'}``."""
    from repro_torch.models import ssm
    token = ssm.META_SCAN.set(grouped_scan)
    try:
        with LiveBytes(args) as lb:
            result = fn()
    finally:
        ssm.META_SCAN.reset(token)
    return result, {"argument_bytes": lb.arg_bytes,
                    "peak_above_arguments": lb.peak,
                    "output_bytes": lb.output_bytes(result)}
