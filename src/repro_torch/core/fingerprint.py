"""Strict tracing of model initialization: per-weight data-flow-graph
fingerprints (TIDAL §4.1, Figure 10 left).

A weight's DFG records how it was produced: which checkpoint it was loaded
from, under which key, with which shape and dtype, and which transforms
followed.  Two invocations whose DFGs match for a weight make it
request-agnostic (static, forked from the template); a mismatch (a LoRA
adapter loaded from a request-specific checkpoint) makes it dynamic.

The port of ``repro.core.fingerprint``: initialization code calls
``api.load`` and the transforms of :class:`TracedArray`, each of which
extends the fingerprint, and the params tree carries one fingerprint per
leaf.  Data are CPU tensors, materialized lazily: a weight forked from the
template never re-materializes on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.utils import named_leaves

Fingerprint = tuple  # nested tuples, hashable


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass
class TracedArray:
    """A host weight tensor plus the DFG that produced it.

    ``_data`` may be None for a deferred value: ``materialize`` runs the
    recorded transform chain only when the value is needed."""
    fp: Fingerprint
    shape: tuple
    dtype: torch.dtype
    _data: Optional[torch.Tensor] = None
    _thunk: Optional[Callable[[], torch.Tensor]] = None

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n * torch.empty((), dtype=self.dtype).element_size()

    def materialize(self) -> torch.Tensor:
        if self._data is None:
            if self._thunk is None:
                raise ValueError(f"no data source for {self.fp!r}")
            self._data = self._thunk()
        return self._data

    # ---- traced transforms (each extends the DFG) -----------------------
    def astype(self, dtype: torch.dtype) -> "TracedArray":
        return TracedArray(
            fp=("astype", _dtype_name(dtype), self.fp), shape=self.shape,
            dtype=dtype, _thunk=lambda: self.materialize().to(dtype))

    def reshape(self, *shape) -> "TracedArray":
        shape = (tuple(shape[0]) if len(shape) == 1
                 and isinstance(shape[0], (tuple, list)) else tuple(shape))
        return TracedArray(
            fp=("reshape", shape, self.fp), shape=shape, dtype=self.dtype,
            _thunk=lambda: self.materialize().reshape(shape))

    def select(self, index: int) -> "TracedArray":
        """Row ``index`` of the leading axis (one layer of a stacked delta)."""
        return TracedArray(
            fp=("select", int(index), self.fp), shape=self.shape[1:],
            dtype=self.dtype, _thunk=lambda: self.materialize()[index])

    def shard(self, spec, plan) -> "TracedArray":
        """The plan's rank's piece of this value under ``spec`` (a merged
        LoRA delta cut as its target is)."""
        from repro_torch.distributed.sharding import shard_for_rank
        shape = list(self.shape)
        if spec.model_dim is not None:
            from repro_torch.distributed.sharding import piece_size
            shape[spec.model_dim] = piece_size(spec, shape[spec.model_dim],
                                               plan.tp, plan.rank)
        return TracedArray(
            fp=("shard", repr(spec), plan.tp, plan.rank, self.fp),
            shape=tuple(shape), dtype=self.dtype,
            _thunk=lambda: shard_for_rank(self.materialize(), spec, plan))

    def scale(self, alpha: float) -> "TracedArray":
        return TracedArray(
            fp=("scale", float(alpha), self.fp), shape=self.shape,
            dtype=self.dtype, _thunk=lambda: self.materialize() * alpha)

    def add(self, other: "TracedArray") -> "TracedArray":
        """Elementwise add, e.g. merging a LoRA delta into a base weight."""
        assert self.shape == other.shape, (self.shape, other.shape)
        return TracedArray(
            fp=("add", self.fp, other.fp), shape=self.shape, dtype=self.dtype,
            _thunk=lambda: self.materialize() + other.materialize().to(self.dtype))

    def matmul(self, other: "TracedArray") -> "TracedArray":
        """e.g. LoRA A @ B to form the low-rank delta."""
        return TracedArray(
            fp=("matmul", self.fp, other.fp),
            shape=self.shape[:-1] + other.shape[1:], dtype=self.dtype,
            _thunk=lambda: self.materialize() @ other.materialize())


@dataclasses.dataclass
class Checkpoint:
    """A named host-side checkpoint (the unit ``api.load`` reads).

    ``arrays`` maps a key to a CPU tensor (or a callable returning one).
    Loads from different uris give different fingerprints, which is how
    LoRA adapters are detected as dynamic."""
    uri: str
    arrays: dict

    def load(self, key: str) -> TracedArray:
        src = self.arrays[key]
        data = src() if callable(src) else src
        return TracedArray(
            fp=("load", self.uri, key, tuple(data.shape),
                _dtype_name(data.dtype)),
            shape=tuple(data.shape), dtype=data.dtype, _data=data)

    def load_all(self) -> dict:
        return {k: self.load(k) for k in self.arrays}


def tree_fingerprints(tree) -> dict:
    """path -> fingerprint for a nested dict/list of TracedArray."""
    return {path: leaf.fp for path, leaf in named_leaves(tree)
            if isinstance(leaf, TracedArray)}


def diff_fingerprints(a: dict, b: dict) -> set:
    """Paths whose DFG differs between two invocations -> dynamic weights."""
    return {k for k in set(a) | set(b) if a.get(k) != b.get(k)}
