"""ZeRO-3 over the data axis, and the data-parallel parts of a training
step (the port's counterpart of what GSPMD derives from the reference's
FSDP specs, ``repro.distributed.sharding.param_specs(fsdp=True)``).

Under a training plan (``sharding.training_plan``) every rank holds its
piece of every leaf: its 'model' shard, cut again over the data axis on
the dimension the spec names ('data'; under ``mode='fsdp2d'`` the whole
grid or 'model' alone, with no tensor parallelism).  :class:`Layout`
knows each leaf's piece:

  * :meth:`Layout.materialize` gathers a leaf just before the layer that
    reads it runs (one ``all_gather`` over the group its storage axis
    spans; ``models.transformer`` calls :func:`gathered` per layer, for
    the embedding and for the head).  The whole leaf is not kept: a
    saved-tensor hook (:func:`use_layout`) saves the piece in its
    place, and the backward gathers it again when it first needs it;
  * the gathered leaf's backward is the gradient's ``reduce_scatter``
    over that group, an ``all_reduce`` over the rest of the ranks whose
    batches differ (the data axis; the whole grid under fsdp2d, where a
    data slice's ranks compute alike), and the division that makes it
    the mean over the global batch.  A leaf that is not cut over 'data'
    takes the ``all_reduce`` alone;
  * the optimizer reads :meth:`Layout.split_dims` (the groups that hold
    the other pieces of a split dimension: a factored second moment sums
    its row and column means over them), :meth:`Layout.copies` (how
    many ranks hold the same piece: the global norm counts a leaf once)
    and :meth:`Layout.model_weights` (a 'model' dimension whose parts
    some ranks hold alike, as Mamba2's B / C columns of ``in_proj``:
    those elements count once too).

With a remat'd block (``cfg.remat``) the recomputed forward gathers its
leaves again and no saved-tensor hook is reached inside it.

:func:`batch_sum` reduces a per-batch statistic over the ranks whose
batches differ (the moe load-balancing loss takes the global batch's
fractions and mean probabilities, as the reference's one program does).
Its backward scales by the number of batch shards, so that the mean the
leaves' backward takes leaves that statistic's gradient whole.

Every collective counts in ``sharding.collective_stats`` under its kind;
over ``meta`` tensors it never runs, and counts inside
``sharding.counting_meta`` (the dry run's shape-only trace).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
import weakref
from typing import Any, Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import DATA, MODEL, PartitionSpec
from repro_torch.utils import map_with_path, named_leaves


@dataclasses.dataclass(frozen=True)
class _Axis:
    """One group of ranks: the process group, its size and this rank's
    index in it."""
    group: Any
    n: int
    index: int


def _all_gather(piece: torch.Tensor, dim: int, axis: _Axis) -> torch.Tensor:
    import torch.distributed as dist
    piece = piece.contiguous()
    t0 = time.perf_counter()
    parts = [torch.empty_like(piece) for _ in range(axis.n)]
    if piece.is_meta:
        full = torch.cat(parts, dim=dim)
        sharding.count_meta_collective("all_gather", full)
        return full
    dist.all_gather(parts, piece, group=axis.group)
    sharding.count_collective("all_gather", t0,
                              piece.numel() * piece.element_size() * axis.n)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(full: torch.Tensor, dim: int, axis: _Axis) -> torch.Tensor:
    import torch.distributed as dist
    chunks = [c.contiguous() for c in full.chunk(axis.n, dim=dim)]
    out = torch.empty_like(chunks[0])
    t0 = time.perf_counter()
    if full.is_meta:
        sharding.count_meta_collective("reduce_scatter", full)
        return out
    dist.reduce_scatter(out, chunks, group=axis.group)
    sharding.count_collective("reduce_scatter", t0,
                              full.numel() * full.element_size())
    return out


def all_reduce(t: torch.Tensor, axis: _Axis, op=None) -> torch.Tensor:
    """``t`` summed (or ``op``) over ``axis``'s ranks in place."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    if t.is_meta:
        sharding.count_meta_collective("all_reduce", t)
        return t
    dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=axis.group)
    sharding.count_collective("all_reduce", t0, t.numel() * t.element_size())
    return t


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """How a rank holds one leaf: the dimension its storage axis cuts
    (None: whole over the data axis), that axis, and the groups its
    gradient's mean runs over (``rest``: an all_reduce after the
    scatter; ``n_mean``: the ranks the mean divides by)."""
    dim: Optional[int]
    store: Optional[_Axis]
    rest: Optional[_Axis]
    n_mean: int

    def gather(self, piece: torch.Tensor) -> torch.Tensor:
        if self.store is None:
            return piece
        return _all_gather(piece, self.dim, self.store)

    def reduce_grad(self, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.contiguous()
        if self.store is not None:
            grad = _reduce_scatter(grad, self.dim, self.store)
        if self.rest is not None:
            grad = all_reduce(grad, self.rest)
        return grad / self.n_mean


class _Materialize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, piece, leaf):
        ctx.leaf = leaf
        return leaf.gather(piece)

    @staticmethod
    def backward(ctx, grad):
        return ctx.leaf.reduce_grad(grad), None


class Layout:
    """Each leaf's piece on this rank under a training plan (see the
    module doc).  ``specs`` are the plan's parameter specs
    (``sharding.plan_param_specs``)."""

    def __init__(self, plan, specs):
        D, M = plan.mesh.data, plan.mesh.model
        self.model = _Axis(plan.group, M, plan.rank)
        self.data = _Axis(plan.data_group, D, plan.data_rank)
        self.world = _Axis(plan.world_group, D * M, plan.world_rank)
        self.specs = dict(named_leaves(specs))
        self.fsdp2d = plan.mode == "fsdp2d"
        # the ranks whose batches differ, and the mean over them
        self.mean_axis = self.world if self.fsdp2d else self.data
        self._leaves = {p: self._leaf(s) for p, s in self.specs.items()}
        # gathered leaves of the step in flight: id -> (weakref, _Regather)
        self._gathered: dict = {}
        self._weights: dict = {}          # model_weights by path

    def _leaf(self, spec: PartitionSpec) -> _Leaf:
        n_mean = self.mean_axis.n
        for d, entry in enumerate(spec):
            if entry == (DATA, MODEL):
                return _Leaf(d, self.world, None, n_mean)
            if entry == DATA and self.data.n > 1:
                return _Leaf(d, self.data, None, n_mean)
            if entry == MODEL and self.fsdp2d:
                return _Leaf(d, self.model,
                             self.data if self.data.n > 1 else None, n_mean)
        return _Leaf(None, None, self.mean_axis if n_mean > 1 else None,
                     n_mean)

    @property
    def active(self) -> bool:
        """True when a leaf is stored cut or its gradient needs a mean
        over other ranks' batches."""
        return self.mean_axis.n > 1

    def materialize(self, path: str, piece: torch.Tensor) -> torch.Tensor:
        """The whole leaf (this rank's 'model' shard of it) from its
        piece, gathered with the backward of the module doc."""
        leaf = self._leaves[path]
        if not self.active:
            return piece
        full = _Materialize.apply(piece, leaf)
        if leaf.store is not None:
            self._gathered[id(full)] = (weakref.ref(full),
                                        _Regather(piece, leaf))
        return full

    def pack(self, t: torch.Tensor):
        entry = self._gathered.get(id(t))
        if entry is not None and entry[0]() is t:
            entry[1].packs += 1
            return entry[1]
        return t

    @staticmethod
    def unpack(packed):
        return packed.value() if isinstance(packed, _Regather) else packed

    def end_step(self) -> None:
        self._gathered.clear()

    # ---- what the optimizer reads -------------------------------------------
    def split_dims(self, path: str) -> dict:
        """{dimension: _Axis} of the dimensions of a leaf whose other
        pieces other ranks hold (its 'model' split under tensor
        parallelism and its storage axis)."""
        spec = self.specs[path]
        out = {}
        d = spec.model_dim
        if d is not None and not self.fsdp2d and self.model.n > 1:
            out[d] = self.model
        leaf = self._leaves[path]
        if leaf.store is not None:
            out[leaf.dim] = leaf.store
        return out

    def model_weights(self, path: str) -> Optional[tuple]:
        """``(dim, weights)`` for a leaf whose 'model' dimension is cut in
        parts (``PartitionSpec.parts``) some of which several model ranks
        hold alike (a part of ``g`` pieces over ``tp`` ranks: each element
        on ``tp / g`` of them; a KV head of an uneven split on the ranks
        of its block): ``weights`` [the piece's size on ``dim``] is one
        over those ranks per element, so a sum over the ranks counts each
        element once.  None for every other leaf."""
        if path not in self._weights:
            spec, tp = self.specs[path], self.model.n
            d = spec.model_dim
            out = None
            if (d is not None and not self.fsdp2d and tp > 1 and spec.parts
                    and any(g != tp for _, g in spec.parts)):
                out = (d, torch.cat([
                    torch.full((width,), weight) for width, weight in
                    sharding.piece_weights(spec, tp, self.model.index)]))
            self._weights[path] = out
        return self._weights[path]

    def copies(self, path: str) -> int:
        """Ranks holding the same piece of a leaf as this one."""
        pieces = 1
        for axis in self.split_dims(path).values():
            pieces *= axis.n
        return self.world.n // pieces

    def global_shape(self, path: str, shape: tuple) -> tuple:
        """The whole leaf's shape from a piece's."""
        out = list(shape)
        spec = self.specs[path]
        for d, axis in self.split_dims(path).items():
            if d == spec.model_dim and spec.parts and axis is self.model:
                out[d] = sum(size for size, _ in spec.parts)
            else:
                out[d] *= axis.n
        return tuple(out)


class _Regather:
    """A gathered leaf's place in the saved tensors: its piece, gathered
    again (once for every node that saved it) when the backward first
    reads it."""

    def __init__(self, piece: torch.Tensor, leaf: _Leaf):
        self.piece, self.leaf = piece, leaf
        self.packs = 0
        self._full = None

    def value(self) -> torch.Tensor:
        full = self._full
        if full is None:
            with torch.no_grad():
                full = self.leaf.gather(self.piece)
        self.packs -= 1
        self._full = full if self.packs > 0 else None
        return full


_LAYOUT: contextvars.ContextVar = contextvars.ContextVar("fsdp_layout",
                                                         default=None)


@contextlib.contextmanager
def use_layout(layout: Optional[Layout]):
    """Scope of a training forward under ``layout``: :func:`gathered`
    gathers, and saved gathered leaves keep their pieces only."""
    if layout is None or not layout.active:
        yield
        return
    token = _LAYOUT.set(layout)
    try:
        with torch.autograd.graph.saved_tensors_hooks(layout.pack,
                                                      layout.unpack):
            yield
    finally:
        _LAYOUT.reset(token)


def gathered(tree, prefix: str):
    """``tree`` (the leaves under path ``prefix``) with every leaf whole
    on the model axis: gathered inside :func:`use_layout`, else itself."""
    layout = _LAYOUT.get()
    if layout is None:
        return tree
    if isinstance(tree, torch.Tensor):
        return layout.materialize(prefix, tree)
    return map_with_path(layout.materialize, tree, prefix + ".")


class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, scale):
        ctx.scale = scale
        buf = x.float().clone()
        all_reduce(buf, axis)
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None, None


def batch_split() -> bool:
    """True inside :func:`use_layout` when the batch is split over
    ranks."""
    layout = _LAYOUT.get()
    return layout is not None and layout.data.n > 1


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis's batch shards (see the module
    doc); ``x`` itself when the batch is not split."""
    layout = _LAYOUT.get()
    if layout is None or layout.data.n == 1:
        return x
    return _BatchSum.apply(x, layout.data, float(layout.data.n))


def batch_mean(x: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """The mean of a per-shard value (a loss) over the batch shards, with
    no gradient (the metric of a step)."""
    if layout is None or layout.data.n == 1:
        return x
    buf = x.detach().float().clone()
    return all_reduce(buf, layout.data) / layout.data.n
