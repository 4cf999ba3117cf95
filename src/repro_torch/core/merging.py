"""Weight tensor merging (TIDAL §6 "tailored memory pool", Table 3).

Transferring thousands of small tensors one by one saturates the copy
command queue; TIDAL's template server merges access-order-adjacent
weights into fewer contiguous buffers once their count exceeds a
threshold (Llama2-70B: 1200 tensors -> 300 groups in the paper).

``plan_groups`` produces the merge plan (a pure function of order and
sizes, the port's copy of ``repro.core.merging``); ``MergedHostBuffer``
is the host-side layout: one contiguous byte buffer per group, weights at
recorded offsets, so a group moves with one copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class MergeGroup:
    keys: tuple                  # WeightKeys, in access order
    offsets: tuple               # byte offset of each weight in the buffer
    total_bytes: int


def plan_groups(order: Sequence, sizes: dict, max_groups: int,
                threshold: int = 0) -> list:
    """Greedy contiguous grouping of the access-ordered weight list.

    With ``len(order) <= max(threshold, max_groups)`` nothing merges (one
    group per weight).  Group boundaries never reorder weights, so the
    streaming order is kept exactly."""
    order = list(order)
    if not order:
        return []
    if len(order) <= max(threshold, max_groups):
        return [MergeGroup(keys=(k,), offsets=(0,), total_bytes=sizes[k])
                for k in order]
    target = sum(sizes[k] for k in order) / max_groups
    groups: list = []
    cur: list = []
    acc = 0
    for k in order:
        cur.append(k)
        acc += sizes[k]
        if acc >= target and len(groups) < max_groups - 1:
            groups.append(_mk_group(cur, sizes))
            cur, acc = [], 0
    if cur:
        groups.append(_mk_group(cur, sizes))
    return groups


def _mk_group(keys: list, sizes: dict) -> MergeGroup:
    offsets, off = [], 0
    for k in keys:
        offsets.append(off)
        off += sizes[k]
    return MergeGroup(keys=tuple(keys), offsets=tuple(offsets), total_bytes=off)


class MergedHostBuffer:
    """Host-side contiguous byte buffer for one merge group."""

    def __init__(self, group: MergeGroup, pin: bool = False):
        self.group = group
        self.buf = torch.zeros(group.total_bytes, dtype=torch.uint8)
        if pin:
            self.buf = self.buf.pin_memory()
        self._views: dict = {}

    def write(self, key, t: torch.Tensor) -> None:
        off = self.group.offsets[self.group.keys.index(key)]
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        self.buf[off:off + flat.numel()] = flat
        self._views[key] = (off, tuple(t.shape), t.dtype)

    def read(self, key) -> torch.Tensor:
        off, shape, dtype = self._views[key]
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        return self.buf[off:off + n].view(dtype).reshape(shape)


def validate_plan(order: Sequence, sizes: dict, groups: Sequence) -> None:
    """Invariants: every weight once, in the original order; dense,
    non-overlapping offsets; total bytes preserved."""
    flat = [k for g in groups for k in g.keys]
    assert flat == list(order), "merge plan must preserve access order"
    for g in groups:
        off = 0
        for k, o in zip(g.keys, g.offsets):
            assert o == off, "offsets must be dense"
            off += sizes[k]
        assert off == g.total_bytes
    assert sum(g.total_bytes for g in groups) == sum(sizes[k] for k in order)
