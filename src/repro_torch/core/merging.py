"""Weight tensor merging (TIDAL §6 "tailored memory pool", Table 3).

Transferring thousands of small tensors one by one saturates the copy
command queue; TIDAL's template server merges access-order-adjacent
weights into fewer contiguous buffers once their count exceeds a
threshold (Llama2-70B: 1200 tensors -> 300 groups in the paper).

``plan_groups`` produces the merge plan (a pure function of order and
sizes, the port's copy of ``repro.core.merging``); ``MergedHostBuffer``
is the host-side layout: one contiguous byte buffer per group, weights at
recorded offsets, so a group moves with one copy.

``HostBuffer`` is the memory under both that layout and the template
server's host pool: one allocation of the exact byte count, page-locked
in place (``cudaHostRegister``) when it feeds a card.  PyTorch's pinned
allocator would round every block up to a power of two (a 7.5 GB leaf
takes 8 GiB), so a pool pinned leaf by leaf held up to twice the model's
bytes.  ``pack_host_pool`` lays a function's static weights out in one
such buffer in access order; the pool's tensors are views into it.
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


# byte alignment of every weight in a packed host pool (a multiple of
# every element size, and of the 16 bytes a vector load takes)
HOST_ALIGN = 256


class HostBuffer:
    """``nbytes`` of host memory as one uint8 tensor ``buf``: one
    allocation of exactly that size, nothing rounded up.

    :meth:`pin` page-locks it in place with ``cudaHostRegister``, so
    copies from its views to a card run as asynchronous DMA
    (``Tensor.is_pinned()`` is true for every view: it asks about the
    storage's base address, the start of the registered range);
    :meth:`release`, or collecting the buffer, unregisters it.  Keep the
    ``HostBuffer`` alive while its views are in use."""

    def __init__(self, nbytes: int):
        self.nbytes = int(nbytes)
        self.buf = torch.empty(self.nbytes, dtype=torch.uint8)
        self.pinned = False

    def pin(self) -> None:
        """Page-lock the buffer (needs a card)."""
        if not self.pinned and self.nbytes:
            torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
                self.buf.data_ptr(), self.nbytes, 0))
            self.pinned = True

    def view(self, offset: int, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """The bytes at ``offset`` as a tensor of ``shape`` and ``dtype``."""
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        return self.buf[offset:offset + n].view(dtype).reshape(shape)

    def release(self) -> None:
        """Unregister the page lock (after the card's pending copies);
        the views stay readable as pageable memory."""
        if self.pinned:
            self.pinned = False
            torch.cuda.synchronize()
            torch.cuda.check_error(
                torch.cuda.cudart().cudaHostUnregister(self.buf.data_ptr()))

    def __del__(self):
        try:
            self.release()
        except Exception:               # interpreter shutdown
            pass


def host_layout(leaves: Sequence) -> tuple:
    """Offsets of ``(path, nbytes)`` pairs packed in order, each at a
    multiple of ``HOST_ALIGN``: returns ``({path: offset}, total bytes)``."""
    offsets, off = {}, 0
    for path, n in leaves:
        off = -(-off // HOST_ALIGN) * HOST_ALIGN
        offsets[path] = off
        off += int(n)
    return offsets, off


def pack_host_pool(leaves: Sequence, pin: bool = False) -> tuple:
    """A function's host pool: ``leaves`` are ``(path, TracedArray)``
    pairs in access order, laid out by :func:`host_layout` in one
    :class:`HostBuffer`, page-locked after the copies with ``pin``.  Each
    leaf is materialized and copied in, one at a time.  Returns ``(buffer,
    {path: view})``."""
    offsets, total = host_layout([(path, leaf.nbytes) for path, leaf in leaves])
    hb = HostBuffer(total)
    pool = {}
    for path, leaf in leaves:
        t = leaf.materialize()
        if t.dtype != leaf.dtype or tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: materialized {tuple(t.shape)} {t.dtype}, "
                             f"traced {tuple(leaf.shape)} {leaf.dtype}")
        pool[path] = hb.view(offsets[path], tuple(leaf.shape), leaf.dtype)
        pool[path].copy_(t)
    if pin:
        hb.pin()
    return hb, pool


class MergedHostBuffer:
    """Host-side contiguous byte buffer for one merge group."""

    def __init__(self, group: MergeGroup, pin: bool = False):
        self.group = group
        self.host = HostBuffer(group.total_bytes)
        if pin:
            self.host.pin()
        self.buf = self.host.buf
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
