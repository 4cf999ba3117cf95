"""Template server: host pinned pool, device-resident templates and
adaptive state forking (TIDAL §5.2, Figure 12 left).

Per registered function the server keeps:

  * the :class:`FunctionTemplate` (access order, kernel set, fingerprints,
    Eq. 1 residency, merge plan), traced on ``meta`` tensors;
  * host-pool copies of every static weight: views into ONE host buffer
    of the static weights' exact bytes, laid out in traced access order
    (``merging.pack_host_pool``) and page-locked when the function's
    model lives on a card.  A re-register packs a new buffer, except
    where the caller asks to keep it (``keep_host_pool``: a runtime
    adopting a function that another runtime registered over this
    shared server) and the same function object's static weights and
    their order are unchanged;
  * device tensors for the access-order resident prefix.

``fork`` implements adaptive state forking for a new invocation:

  * the initializer re-runs under strict tracing (cheap: TracedArrays
    are lazy, nothing static materializes);
  * fingerprints are diffed against the template, and newly dynamic
    weights are excluded incrementally;
  * static weights: resident ones are SHARED device tensors (every fork
    reads the same buffers; ``forking.DonationGuard`` checks that no
    invocation writes them), the rest stream in access order;
  * dynamic weights are replayed from the traced DFG (materialized and
    copied), the only per-request work: under 1% of the model for LoRA.

The port's copy of ``repro.core.template_server``.  Under a sharding plan
(the functions' models') the server is one rank's: its host pool, its
resident prefix and its streams hold the rank's shard (the function's
initializer gives the rank's leaves: ``Model.init_params`` and
``convert.params_from_jax`` under a plan), and ``register``, ``fork``,
``set_resident_bytes`` and ``observe_ttft`` are device ops of the
tensor-parallel channel, so every rank's residency follows the same
decisions.  ``ForkStats`` then reports this rank's bytes, and the
controller's copy lists every rank's under ``per_rank``.

Several serving instances fork one function onto their devices
(``fork(..., device=)``, the counterpart of the JAX server's per-call
mesh slice): the resident prefix is placed once per (function, device)
and reused by every later fork there (``_resident_for``), and dropped
whenever residency changes (``_invalidate_placements``).  Instances on
the function's own device share the one set of resident buffers, so
``device_bytes_used`` counts them once; ``model_on`` gives the
function's model on another device.

Several tensor-parallel instances (one rank group each,
``distributed.group``) fork onto another rank group with ``fork(...,
plan=)``: every rank of every instance holds a server with its rank's
shard in its own pinned host pool (so a machine pins each shard once per
rank group), registration and Eq. 1 feedback reach them all, and a fork
runs on the ranks of the plan's instance only.  The controller's copy
of a fork onto another instance runs on its shadows (``meta`` tensors:
no bytes move), with resident buffers per plan as in the reference's
``_resident_for``.  A fork first offers the event to every instance's
template (``observe_event``), so a weight a fork on one instance finds
dynamic leaves every rank's pool and resident prefix alike.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.api import LLMFunction
from repro_torch.core.merging import pack_host_pool
from repro_torch.core.streaming import ForkSession, StreamEntry, WeightStreamer
from repro_torch.core.template import FunctionTemplate, generate_template
from repro_torch.core.tracing import trace_weight_access, weight_sizes
from repro_torch.distributed import sharding
from repro_torch.distributed.group import SHADOW_DEVICE, current_group, mirrored
from repro_torch.hw import H100_SXM, HardwareProfile
from repro_torch.models.registry import get_model, resolve_device
from repro_torch.utils import named_leaves, tensor_nbytes


@dataclasses.dataclass
class ForkStats:
    reused_bytes: int = 0        # shared device buffers (resident prefix)
    streamed_bytes: int = 0      # async host->device in access order
    dynamic_bytes: int = 0       # replayed request-specific weights
    fork_s: float = 0.0
    new_dynamic: tuple = ()
    replicated_bytes: int = 0    # of the above, bytes every rank holds alike
    per_rank: tuple = ()         # every rank's stats (the controller's copy)


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A device copy that never aliases the host pool."""
    return t.to(device, copy=True)


class TemplateServer:
    @mirrored(register=("self",))
    def __init__(self, hw: HardwareProfile = H100_SXM,
                 device_budget_bytes: int = 1 << 62,
                 trace_batch: int = 1, trace_seq: int = 64, plan=None):
        self.hw = hw
        # the functions' sharding plan (None: one device)
        self.plan = None if plan is None or plan.tp == 1 else plan
        self.device_budget = device_budget_bytes
        self.trace_batch = trace_batch
        self.trace_seq = trace_seq
        self.templates: dict = {}                     # fn -> FunctionTemplate
        # fn -> int32 tokens of the function's shared prompt prefix: warm
        # state beyond weights, baked once into pinned arena pages
        self.template_prompts: dict = {}
        self.host_pool: dict = {}                     # fn -> path -> tensor
        self.host_buffers: dict = {}                  # fn -> HostBuffer
        self._packed_from: dict = {}                  # fn -> LLMFunction
        self.device_cache: dict = {}                  # fn -> path -> tensor
        self._leaf_order: dict = {}                   # fn -> [path, ...]
        self._leaf_specs: dict = {}                   # fn -> path -> spec
        # (fn, device) -> resident buffers placed on another device than
        # the function's model's, and the function's model there
        self._placed_resident: dict = {}
        self._placed_models: dict = {}
        self._functions: dict = {}

    def mirror_digest(self) -> str:
        """Host state compared across ranks by the divergence guard."""
        return repr(sorted((fn, sorted(c)) for fn, c in
                           self.device_cache.items()))

    def _specs_for(self, fn_name: str):
        """{path -> PartitionSpec} of the function's parameters under the
        server's plan (None on one device), cached per function."""
        if self.plan is None:
            return None
        if fn_name not in self._leaf_specs:
            model = self._functions[fn_name].model
            self._leaf_specs[fn_name] = sharding.leaf_param_specs(
                model, self.plan.mesh)
        return self._leaf_specs[fn_name]

    def _other_plan(self, plan) -> bool:
        """``plan`` is another instance's rank group than the server's."""
        return (plan is not None and plan.tp > 1 and self.plan is not None
                and plan.instance != self.plan.instance)

    def model_on(self, fn_name: str, device, plan=None) -> object:
        """The function's model on ``device`` (under ``plan``, another
        instance's rank group: the controller's shadow of it): its own
        model when it lives there, else one copy per device and plan
        (same config)."""
        model = self._functions[fn_name].model
        device = resolve_device(device)
        other = self._other_plan(plan)
        if device == model.device and not other:
            return model
        key = (fn_name, device, plan.instance if other else None)
        if key not in self._placed_models:
            self._placed_models[key] = get_model(
                model.cfg, device=device, plan=plan if other else model.plan)
        return self._placed_models[key]

    def _resident_for(self, fn_name: str, device: torch.device,
                      plan=None) -> dict:
        """The resident prefix as shared device buffers on ``device``:
        placed once per (function, device, plan) and reused by every later
        fork there.  On the function's own device, the template's
        buffers."""
        base = self.device_cache.get(fn_name, {})
        other = self._other_plan(plan)
        if device == self._functions[fn_name].model.device and not other:
            return dict(base)
        key = (fn_name, device, plan.instance if other else None)
        if key not in self._placed_resident:
            self._placed_resident[key] = {path: _to_device(t, device)
                                          for path, t in base.items()}
        return dict(self._placed_resident[key])

    def _invalidate_placements(self, fn_name: str) -> None:
        for key in [k for k in self._placed_resident if k[0] == fn_name]:
            del self._placed_resident[key]

    # ------------------------------------------------------------------
    def device_bytes_used(self) -> int:
        """Bytes of resident buffers on every device, each buffer once."""
        placed = [self.device_cache, self._placed_resident]
        return sum(tensor_nbytes(t) for cache in placed
                   for d in cache.values() for t in d.values())

    def registered_bytes(self) -> int:
        """Host bytes the pools hold page-locked in place (PyTorch's pinned
        allocator statistics do not see them)."""
        return sum(b.nbytes for b in self.host_buffers.values() if b.pinned)

    @mirrored()
    def register(self, fn: LLMFunction, example_event: dict,
                 resident_bytes: int = 0, template_prompt=None,
                 keep_host_pool: bool = False) -> FunctionTemplate:
        """Build the function's template (offline or at first invocation).

        ``template_prompt`` records the function's shared prompt prefix:
        runtimes bake its KV at deploy and serve later invocations
        suffix-only.  ``keep_host_pool`` keeps the host pool packed for
        this same function object when its static weights and their
        order are unchanged (else, and by default, a new one is
        packed)."""
        model = fn.model
        if model.plan != self.plan:
            raise ValueError(f"{fn.name}: its model's sharding plan is not "
                             "the template server's")
        # a re-register without a template opts out; the new entry lands
        # only after the initializer ran (a failing one records nothing)
        self.template_prompts.pop(fn.name, None)
        traced, fps = fn.run_initializer(example_event)

        specs = model.param_specs()
        B, S = self.trace_batch, self.trace_seq
        # the model's own prefill over meta inputs (enc-dec: frames too)
        inputs = model.input_specs("prefill", B, S)
        cache = model.make_cache(B, S, device="meta")
        trace = trace_weight_access(
            lambda p, i, c: model.prefill(p, i, c), specs, inputs, cache)
        template = generate_template(fn.name, trace,
                                     weight_sizes(specs, trace.order), fps,
                                     resident_bytes=resident_bytes)
        self.templates[fn.name] = template
        self._functions[fn.name] = fn
        self._leaf_specs.pop(fn.name, None)
        for key in [k for k in self._placed_models if k[0] == fn.name]:
            del self._placed_models[key]
        self._leaf_order[fn.name] = [path for path, _ in trace.order]

        # host pool: materialize static weights once, in access order,
        # into one buffer (pinned for a card)
        leaves = dict(named_leaves(traced))
        order = [p for p in self._leaf_order[fn.name] if p in leaves]
        seen = set(order)
        order += [p for p in leaves if p not in seen]
        static = [p for p in order if p not in template.dynamic]
        if (not keep_host_pool or self._packed_from.get(fn.name) is not fn
                or list(self.host_pool.get(fn.name, ())) != static):
            self.host_pool.pop(fn.name, None)     # a re-register's old pool
            self.host_buffers.pop(fn.name, None)
            self.host_buffers[fn.name], self.host_pool[fn.name] = \
                pack_host_pool([(p, leaves[p]) for p in static],
                               pin=model.device.type == "cuda")
            self._packed_from[fn.name] = fn
        self._refresh_residency(fn.name)
        if template_prompt is not None:
            self.template_prompts[fn.name] = np.asarray(
                template_prompt, np.int32).reshape(-1)
        return template

    # ------------------------------------------------------------------
    def _resident_leaves(self, fn_name: str) -> list:
        """Access-order prefix of static weights within the Eq. 1 budget."""
        t = self.templates[fn_name]
        pool = self.host_pool[fn_name]
        budget = min(t.resident_bytes, self.device_budget)
        out = []
        for path in self._leaf_order[fn_name]:
            if path in t.dynamic or path not in pool:
                continue
            n = tensor_nbytes(pool[path])
            if n > budget:
                break
            out.append(path)
            budget -= n
        return out

    def _refresh_residency(self, fn_name: str) -> None:
        self._invalidate_placements(fn_name)
        pool = self.host_pool[fn_name]
        want = self._resident_leaves(fn_name)
        cache = self.device_cache.setdefault(fn_name, {})
        device = self._functions[fn_name].model.device
        for path in [p for p in cache if p not in want]:
            del cache[path]
        for path in want:
            if path not in cache:
                cache[path] = _to_device(pool[path], device)

    @mirrored()
    def set_resident_bytes(self, fn_name: str, nbytes: int) -> None:
        self.templates[fn_name].resident_bytes = int(nbytes)
        self._refresh_residency(fn_name)

    # ------------------------------------------------------------------
    def fork(self, fn_name: str, event: dict, plan=None,
             device=None) -> tuple:
        """Adaptive state forking for one invocation.

        Returns ``(ForkSession, ForkStats)``: resident tensors are shared,
        dynamic weights replayed, and the rest stream in access order on
        the streamer's thread.  Under a plan each rank forks its shard;
        ``plan`` (the JAX signature's per-call mesh slice) is the server's
        or another instance's rank group, whose ranks then run the fork
        (the controller's session is a shadow).  ``device`` forks onto
        another device than the function's model's (another serving
        instance's card): the session then runs ``model_on(fn_name,
        device)``."""
        group = current_group()
        new_dyn = ()
        if group is not None and group.n_instances > 1:
            new_dyn = self.observe_event(fn_name, event)
        session, stats = self._fork(fn_name, event, plan=plan, device=device)
        stats.new_dynamic = new_dyn or stats.new_dynamic
        return session, stats

    @mirrored()
    def observe_event(self, fn_name: str, event: dict) -> tuple:
        """Trace the initializer for ``event`` and drop the weights it
        finds newly dynamic from the host pool and the resident prefix
        (on every rank of every instance).  Returns them."""
        fn = self._functions[fn_name]
        return self._observe(fn_name, fn.run_initializer(event)[1])

    def _observe(self, fn_name: str, fps: dict) -> tuple:
        new_dyn = self.templates[fn_name].observe_init(fps)
        pool = self.host_pool[fn_name]
        for path in new_dyn:         # newly dynamic: out of pool and cache
            pool.pop(path, None)
            self.device_cache.get(fn_name, {}).pop(path, None)
        if new_dyn:
            self._invalidate_placements(fn_name)
        return tuple(sorted(new_dyn))

    @mirrored(register=("return.0",), gather="return.1", route="plan")
    def _fork(self, fn_name: str, event: dict, plan=None,
              device=None) -> tuple:
        t0 = time.perf_counter()
        fn = self._functions[fn_name]
        if self._other_plan(plan):
            device = SHADOW_DEVICE
        model = self.model_on(fn_name, device or fn.model.device, plan)
        device = model.device
        template = self.templates[fn_name]
        pool = self.host_pool[fn_name]

        traced, fps = fn.run_initializer(event)
        new_dyn = self._observe(fn_name, fps)
        traced_by_path = dict(named_leaves(traced))

        stats = ForkStats(new_dynamic=new_dyn)
        resident = self._resident_for(fn_name, device, plan)
        stats.reused_bytes = sum(tensor_nbytes(t) for t in resident.values())

        # dynamic weights: replay the DFG now (request-specific work; a
        # shadow takes the shapes only)
        dynamic: dict = {}
        for path in sorted(template.dynamic):
            ta = traced_by_path[path]
            dynamic[path] = (
                torch.empty(ta.shape, dtype=ta.dtype, device=device)
                if device.type == "meta"
                else _to_device(ta.materialize(), device))
            stats.dynamic_bytes += tensor_nbytes(dynamic[path])

        # the remaining static weights stream in traced access order
        entries = []
        for key in template.static_order:
            path = key[0]
            if path in resident or path in dynamic:
                continue
            src = pool[path]
            entries.append(StreamEntry(key=key, fetch=lambda s=src: s))
            stats.streamed_bytes += tensor_nbytes(src)

        specs = self._specs_for(fn_name)
        if specs is not None:
            held = {**{p: tensor_nbytes(t) for p, t in resident.items()},
                    **{p: tensor_nbytes(t) for p, t in dynamic.items()},
                    **{e.key[0]: tensor_nbytes(pool[e.key[0]])
                       for e in entries}}
            stats.replicated_bytes = sum(
                sharding.whole_bytes(specs[p], n, self.plan.tp, self.plan.rank)
                for p, n in held.items())

        streamer = WeightStreamer(entries, resident, dynamic,
                                  device=device).start()
        session = ForkSession(model, streamer)
        stats.fork_s = time.perf_counter() - t0
        return session, stats

    # ------------------------------------------------------------------
    @mirrored()
    def observe_ttft(self, fn_name: str, ttft_s: float) -> None:
        """Feed a measured TTFT back into Eq. 1 and refresh residency."""
        self.templates[fn_name].observe_ttft(ttft_s, self.hw)
        self._refresh_residency(fn_name)
