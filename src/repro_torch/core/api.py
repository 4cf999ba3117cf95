"""TIDAL programming interface (paper Figure 9), port edition.

    import repro_torch.core.api as tidal

    @tidal.init(static=False)
    def initializer(event, context):
        base = tidal.load(ckpt)                                   # static
        w = tidal.apply_lora(base, model, adapters[event["adapter"]])
        return tidal.assemble(model, w)

    fn = tidal.LLMFunction("llama-lora", model, initializer)

The initializer runs under strict tracing on every invocation (that is how
dynamic weights are detected), but static weights never re-materialize:
their TracedArray stays lazy and the template server forks the existing
buffers instead.

Weights are named by the port's per-layer paths (``layers.3.attn.wq``).
LoRA targets may also be given by the JAX package's stacked names
(``blocks.attn.wq``): :func:`lora_checkpoint` then draws the same factor
shapes in the same order from the same seed as ``repro.core.api``
(A ``[L*D, r]``, B ``[r, E]``), and :func:`apply_lora` splits the merged
delta per layer, so one seed gives the same merged weights in both
packages.  Under a sharding plan (the model's) the factors keep the
model's global widths, drawn alike on every rank, and each rank merges
its shard of ``A @ B`` (its target's spec,
``sharding.lora_delta_spec``) into its shard of the target.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.convert import group_lengths, port_names
from repro_torch.core.fingerprint import Checkpoint, tree_fingerprints
from repro_torch.distributed import sharding
from repro_torch.models.registry import Model
from repro_torch.utils import map_with_path, named_leaves


def init(static: bool = False):
    """Decorator marking a function initializer (paper's ``tidal.init``).

    ``static=True`` promises request-agnostic initialization; without it
    the (traced) initializer re-runs on every invocation."""
    def deco(fn):
        fn._tidal_init = True
        fn._tidal_static = static
        return fn
    return deco


def load(checkpoint: Checkpoint) -> dict:
    """Load a checkpoint into TracedArray handles (strict-traced)."""
    return checkpoint.load_all()


def assemble(model: Model, weights: dict):
    """Arrange a flat ``{path: TracedArray}`` dict into the model's
    parameter structure (checked against its ``meta`` specs)."""
    def pick(path, spec):
        if path not in weights:
            raise KeyError(f"initializer produced no weight for {path}")
        ta = weights[path]
        if tuple(ta.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {ta.shape} != spec {tuple(spec.shape)}")
        return ta
    return map_with_path(pick, model.param_specs())


def checkpoint_of(uri: str, params) -> Checkpoint:
    """A host 'checkpoint' of a concrete parameter tree (CPU tensors):
    the stand-in for a file on storage."""
    return Checkpoint(uri=uri, arrays={path: t.detach().cpu()
                                       for path, t in named_leaves(params)})


def _global_specs(model: Model) -> dict:
    """The model's parameter specs at its global widths (a rank's model
    computes with its shard, ``model.param_specs()``)."""
    return model._family.param_specs(model.cfg)


def _target_shape(model: Model, path: str) -> tuple:
    """Global shape of a LoRA target: a port path, or a JAX stacked path
    (``blocks.*``, xlstm's ``mlstm.*``, ...) as ``[n, ...]``."""
    specs = _global_specs(model)
    names = port_names(path, group_lengths(specs))
    shapes = dict(named_leaves(specs))
    if names != [path]:
        return (len(names),) + tuple(shapes[names[0]].shape)
    return tuple(shapes[path].shape)


def lora_checkpoint(uri: str, model: Model, target_paths: list,
                    rank: int = 8, seed: int = 0) -> Checkpoint:
    """A synthetic LoRA adapter: factors A ``[prod(shape[:-1]), r]`` and
    B ``[r, shape[-1]]`` per target, drawn from ``default_rng(seed)`` in
    target order (A then B), as ``repro.core.api.lora_checkpoint`` draws
    them."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for path in target_paths:
        shape = _target_shape(model, path)
        lead, last = int(np.prod(shape[:-1])), shape[-1]
        a = (rng.standard_normal((lead, rank)) * 0.01).astype(np.float32)
        b = (rng.standard_normal((rank, last)) * 0.01).astype(np.float32)
        arrays[path + ".A"] = torch.from_numpy(a)
        arrays[path + ".B"] = torch.from_numpy(b)
    return Checkpoint(uri=uri, arrays=arrays)


def apply_lora(weights: dict, model: Model, adapter: Checkpoint,
               alpha: float = 1.0) -> dict:
    """Merge a LoRA adapter into base weights (all traced ops).  A target
    named by a JAX stacked path merges row ``i`` of the reshaped delta
    into layer ``i``.  Under the model's sharding plan each layer's delta
    is cut to the rank's shard of its target."""
    plan = model.plan
    specs = (None if plan is None else
             sharding.leaf_param_specs(model, plan.mesh))
    out = dict(weights)
    for path in sorted({k.rsplit(".", 1)[0] for k in adapter.arrays}):
        delta = adapter.load(path + ".A").matmul(
            adapter.load(path + ".B")).scale(alpha)
        delta = delta.reshape(_target_shape(model, path))
        names = port_names(path, group_lengths(_global_specs(model)))
        for i, name in enumerate(names):
            d = delta.select(i) if names != [path] else delta
            if specs is not None:
                d = d.shard(specs[name], plan)
            out[name] = out[name].add(d.astype(out[name].dtype))
    return out


@dataclasses.dataclass
class LLMFunction:
    """One deployed FaaS function: a model plus a traced initializer."""
    name: str
    model: Model
    initializer: Callable            # (event, context) -> traced params tree
    timeout_s: float = 60.0

    @property
    def static(self) -> bool:
        return getattr(self.initializer, "_tidal_static", False)

    def run_initializer(self, event: dict, context: Optional[dict] = None):
        """Execute the initializer under strict tracing.  Returns
        (traced params tree, {path: fingerprint})."""
        traced = self.initializer(event, context or {})
        return traced, tree_fingerprints(traced)


def static_function(name: str, model: Model, params) -> LLMFunction:
    """A function whose initializer always loads the same checkpoint
    (fully static, the paper's non-LoRA case)."""
    ckpt = checkpoint_of(f"ckpt://{name}", params)

    @init(static=True)
    def initializer(event, context):
        return assemble(model, load(ckpt))

    return LLMFunction(name=name, model=model, initializer=initializer)


def lora_function(name: str, model: Model, params, target_paths: list,
                  n_adapters: int = 4, rank: int = 4) -> LLMFunction:
    """A dynamic function: base model plus a request-selected LoRA
    adapter (the paper's multilingual-function case)."""
    base = checkpoint_of(f"ckpt://{name}-base", params)
    adapters = {f"adapter-{i}": lora_checkpoint(f"ckpt://{name}-lora{i}",
                                                model, target_paths,
                                                rank=rank, seed=100 + i)
                for i in range(n_adapters)}

    @init(static=False)
    def initializer(event, context):
        w = apply_lora(load(base), model, adapters[event.get("adapter",
                                                            "adapter-0")])
        return assemble(model, w)

    return LLMFunction(name=name, model=model, initializer=initializer)
