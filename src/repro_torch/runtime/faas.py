"""FaaS front end over the TIDAL stack: the port of
``repro.runtime.faas.FaaSRuntime``.

The front door is the async gateway: ``submit(InvocationRequest)`` returns
an :class:`~repro_torch.runtime.gateway.InvocationHandle` ticket (stream
``tokens()``, block ``result()``, abort ``cancel()``); the positional
``submit(fn_name, event, prompt)`` / ``submit_many(tuples)`` forms are
thin shims over the same gateway with identical greedy results.

It composes:

  * :class:`TemplateServer`: register and fork (static reuse, dynamic
    replay, access-order streaming from the pinned host pool);
  * :class:`ExecutableCache` / :class:`ProcessPool`: §5.1 proactive code
    loading (the engine's entry points warmed at deploy);
  * :class:`ContinuousBatchingEngine`: one warm engine per (function,
    event) is kept alive, so later invocations skip forking.

Invocation kinds are the cluster scheduler's service classes:

  * ``warm``: a live engine existed, service = prefill + decode only;
  * ``fork``: the template existed, a new engine was forked (its prefill
    streams layer by layer while the weights are in flight);
  * ``cold``: the first invocation since deploy (it forks too, and pays
    whatever warming did not cover).

Many functions on one resident base: ``deploy_shared_base`` keeps ONE
engine whose adapter bank serves every function ``attach_adapter``
registers over it, each from its own bank row in one decode batch.

A :class:`~repro_torch.runtime.controlplane.ControlPlane` attached with
``attach_control_plane`` bakes runtime-observed hot prompt prefixes
(``bake_runtime_prefix``), pre-forks engines ahead of forecast arrivals
and sets each function's keep-alive.  :func:`measure_service_times`
turns wall-clock cold/fork/warm measurements into the oracle of the
cluster scheduler (``core.scheduler.SchedulerConfig.measured``).

``mesh=ServingMesh(data, 1)`` serves ``data`` INSTANCES (TIDAL §6 on one
host): instance ``i`` runs on ``cuda:(i mod device_count)`` (on the CPU
every instance runs there), so two instances share a one-card machine.
Every instance owns a KV pool per model (allocated once, engines borrow
slots from it), its own warmed entry points and its own baked prefixes;
instances on one device share the template server's resident buffers.
New engines are placed by the locality policy ``core.scheduler.
ClusterSim`` simulates: prefer the instance already warm for the
function unless it holds more than ``locality_max_extra_load`` engines
over the least-loaded instance.

``mesh=ServingMesh(1, tp)`` serves one tensor-parallel instance: the
runtime is the controller rank of a ``distributed.group`` of ``tp`` ranks
(``spawn``), the only rank with host state, and its functions' models
are built under the group's plan.  Every device op below the engines
runs on every rank (``distributed.group.mirrored``).  A shared base's
adapter bank is the rank's shard on every rank.

``mesh=ServingMesh(data, tp)`` with both above 1 serves ``data``
tensor-parallel instances, each its own rank group of ``tp`` ranks
(``spawn(..., data=data)``), as the reference serves instance ``i`` on
``Mesh(mesh.devices[i:i + 1])``.  The runtime runs on the controller,
rank 0 of instance 0; instance ``i``'s engines, KV pools, fork sessions
and adapter banks are the controller's shadows of the objects its ranks
hold (``distributed.group``), so every device op of instance ``i`` runs
on its ranks alone.  Every instance owns a KV pool per model, built on
its ranks; template prompts bake at deploy on instance 0 and at the
first fork onto each other instance; locality routing is the same.
An enc-dec (whisper) function deploys, unwarmed, and its invocation
raises ``NotImplementedError`` where the continuous engine is built, as
in the JAX runtime.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import api as tidal
from repro_torch.core.api import LLMFunction
from repro_torch.core.prewarm import ExecutableCache, ProcessPool, zero_params
from repro_torch.core.template_server import TemplateServer
from repro_torch.distributed.group import current_group
from repro_torch.distributed.sharding import ServingMesh
from repro_torch.models.adapters import check_bank_config, make_adapter_bank
from repro_torch.models.registry import get_smoke_model, resolve_device
from repro_torch.runtime.continuous import ContinuousBatchingEngine
from repro_torch.runtime.gateway import (InvocationGateway, InvocationHandle,
                                         InvocationRequest)
from repro_torch.runtime.kv_pool import KVCachePool, PagedKVCachePool
from repro_torch.runtime.prefix import PrefixIndex

KINDS = ("warm", "fork", "cold")


def _controller_group(mesh):
    """The group of ``mesh``'s ranks this runtime runs on the controller
    of (``distributed.spawn``)."""
    group = current_group()
    if group is None or group.mesh != mesh:
        raise RuntimeError(
            f"a mesh of {mesh.data} x {mesh.model} ranks serves inside a "
            "group of as many ranks (repro_torch.distributed.spawn(..., "
            f"data={mesh.data}))")
    if not group.is_controller:
        raise RuntimeError("FaaSRuntime runs on the controller rank; the "
                           "workers call group.serve()")
    return group


@dataclasses.dataclass
class _Instance:
    """One serving instance: a device, or the ranks of one tensor-parallel
    group (``plan``; ``device`` is where this process holds its objects:
    the controller's device for its own instance, the shadow device for
    another's)."""
    idx: int
    device: torch.device
    plan: Optional[object] = None
    ranks: tuple = ()


def _make_instances(mesh, device: torch.device) -> list:
    """One instance per ``data`` slice of ``mesh`` (one without a mesh)."""
    if mesh is None:
        return [_Instance(0, device)]
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(
            "serving mesh must have axes ('data', 'model'): one instance "
            f"per data slice, tensor-parallel over model (got "
            f"{mesh.axis_names})")
    data, tp = mesh.shape["data"], mesh.shape["model"]
    if tp > 1:
        group = _controller_group(ServingMesh(data, tp))
        return [_Instance(i, group.device_of(i), group.plans[i],
                          tuple(range(i * tp, (i + 1) * tp)))
                for i in range(data)]
    if device.type != "cuda":
        return [_Instance(i, device) for i in range(data)]
    count = torch.cuda.device_count()
    return [_Instance(i, torch.device("cuda", (device.index + i) % count))
            for i in range(data)]


def _group(inst: _Instance) -> Optional[int]:
    """The rank group an instance is (None: a device)."""
    return None if inst.plan is None else inst.idx


def _engine_key(fn_name: str, event: dict) -> tuple:
    return (fn_name, tuple(sorted((event or {}).items())))


@dataclasses.dataclass
class _WarmEngine:
    engine: ContinuousBatchingEngine
    last_used_s: float
    instance: int = 0
    # shared-adapter engines: fn_name -> bank row already loaded, and the
    # next free row (0 is the null adapter, never assigned)
    adapter_ids: dict = dataclasses.field(default_factory=dict)
    next_adapter_id: int = 1


class FaaSRuntime:
    """Serving runtime for deployed LLM functions on one device, on
    several instances (``mesh=ServingMesh(data, 1)``), on the ranks of
    one tensor-parallel instance (``mesh=ServingMesh(1, tp)``) or of
    several (``mesh=ServingMesh(data, tp)``, one rank group each).

    ``device`` defaults to the card and raises without one; pass
    ``device="cpu"`` to serve on the CPU.  Every deployed function's model
    must live on that device (instance 0's; under a tensor-parallel mesh,
    the controller rank's)."""

    def __init__(self, server: Optional[TemplateServer] = None,
                 n_slots: int = 4, max_len: int = 64,
                 keep_alive_s: float = 60.0, max_warm_engines: int = 8,
                 prewarm: bool = True, pool_workers: int = 2,
                 trace_seq: int = 32, page_size: int = 8,
                 mesh=None, locality_max_extra_load: int = 2,
                 gateway_quantum: int = 2,
                 chunk_tokens: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.0,
                 max_live: Optional[int] = None,
                 brownout_threshold: float = 0.75,
                 brownout_max_new: Optional[int] = None,
                 device="cuda"):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.locality_max_extra_load = locality_max_extra_load
        self.instances = _make_instances(mesh, self.device)
        self.plan = self.instances[0].plan
        self.server = server or TemplateServer(trace_batch=1,
                                               trace_seq=trace_seq,
                                               plan=self.plan)
        if self.server.plan != self.plan:
            raise ValueError("the template server's plan is not the mesh's")
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.chunk_tokens = chunk_tokens
        self.kv_dtype = kv_dtype
        self.keep_alive_s = keep_alive_s
        self.max_warm_engines = max_warm_engines
        self.prewarm = prewarm
        self.exe_cache = ExecutableCache()
        self.workers = ProcessPool(pool_workers, self.exe_cache, self.device)
        self.functions: dict = {}
        self._engines: dict = {}
        self._fn_keys: dict = {}
        self._invoked: set = set()
        # one KV pool per (instance, model): allocated once and lent to
        # engines slot by slot; eviction returns every borrowed slot and page
        self._pools: dict = {}
        # template-baked prompt-prefix KV: one pinned PrefixHandle and one
        # PrefixIndex per (function, instance, event key); static functions
        # share one bake per instance (event key ()), dynamic ones bake per
        # event at fork
        self._prefix_handles: dict = {}
        self._prefix_indexes: dict = {}
        self._baked_events: dict = {}
        # runtime-learned prefixes (control plane), kept apart from
        # template bakes so re-deploys and budget eviction release them
        self._runtime_prefix_handles: dict = {}
        # per-function service-class counters, surfaced by ``stats()``
        self.fn_stats: dict = {}
        # the predictive control plane (None: fixed keep-alive decay)
        self.control_plane = None
        # shared bases (deploy_shared_base) and the adapter functions
        # attached to them: fn_name -> (base, checkpoint, alpha)
        self._shared_bases: dict = {}
        self._adapter_fns: dict = {}
        self.gateway = InvocationGateway(
            self, quantum=gateway_quantum, quantum_tokens=chunk_tokens,
            max_retries=max_retries, retry_backoff_s=retry_backoff_s,
            max_live=max_live, brownout_threshold=brownout_threshold,
            brownout_max_new=brownout_max_new)

    # ------------------------------------------------------------------
    def _model_on(self, fn_name: str, inst: _Instance):
        """The function's model as instance ``inst`` runs it."""
        return self.server.model_on(fn_name, inst.device, inst.plan)

    def _fork(self, fn_name: str, event: dict, inst: _Instance) -> tuple:
        """Fork the function onto instance ``inst`` (its device, or its
        rank group)."""
        if inst.plan is not None:
            return self.server.fork(fn_name, event, plan=inst.plan)
        if inst.device == self.functions[fn_name].model.device:
            return self.server.fork(fn_name, event)
        return self.server.fork(fn_name, event, device=inst.device)

    def _pool_for(self, model, inst: Optional[_Instance] = None) -> object:
        """The KV pool of ``model`` on instance ``inst`` (default: the
        first)."""
        inst = inst or self.instances[0]
        key = (inst.idx, id(model))
        if key not in self._pools:
            if model.supports_paged_kv:
                self._pools[key] = PagedKVCachePool(
                    model, self.n_slots, self.max_len,
                    page_size=self.page_size, plan=model.plan,
                    kv_dtype=self.kv_dtype)
            else:
                self._pools[key] = KVCachePool(model, self.n_slots,
                                               self.max_len, plan=model.plan)
        return self._pools[key]

    def kv_pool_stats(self) -> dict:
        """{(instance, model key): free slot/page counts}: after every
        engine drains or is evicted, all counts are back at their start."""
        out = {}
        for key, pool in self._pools.items():
            if isinstance(pool, PagedKVCachePool):
                out[key] = {"n_free_slots": pool.n_free_slots,
                            "n_free_pages": pool.n_free_pages,
                            "n_available_pages": pool.n_available_pages}
            else:
                out[key] = {"n_free_slots": pool.n_free}
        return out

    # ------------------------------------------------------------------
    def deploy(self, fn: LLMFunction, example_event: Optional[dict] = None,
               prewarm_seq: int = 32,
               template_prompt: Optional[object] = None) -> None:
        """Register the function's template and warm its entry points.

        Warming runs the engine's prefill at ``prewarm_seq`` and the
        pool-shaped decode once, so the first invocation pays forking, not
        first-call costs (§5.1).  ``template_prompt`` (int32 tokens) is the
        function's shared prompt prefix: its KV is baked once into pinned
        pages of the paged arena, and every invocation whose prompt starts
        with it prefills only the suffix.  Over a ``server`` another
        runtime shares, a first deploy of a function object the server
        already holds keeps its host pool; a re-deploy packs anew."""
        if fn.model.device != self.device:
            raise ValueError(f"{fn.name}: model on {fn.model.device}, "
                             f"runtime on {self.device}")
        if fn.model.plan != self.plan:
            raise ValueError(f"{fn.name}: its model's sharding plan is not "
                             "the runtime's mesh's (get_model(..., "
                             "plan=group.plan))")
        if template_prompt is not None:
            if not fn.model.supports_paged_kv:
                raise ValueError(
                    f"{fn.name}: template prompts need a paged attention "
                    f"family (got {fn.model.cfg.family!r})")
            n_tpl = len(np.asarray(template_prompt).reshape(-1))
            if n_tpl > self.max_len - 1:
                raise ValueError(
                    f"{fn.name}: template prompt must leave room for a "
                    f"suffix within max_len={self.max_len}")
            if n_tpl < self.page_size:
                raise ValueError(
                    f"{fn.name}: template prompt of {n_tpl} tokens is "
                    f"shorter than one page ({self.page_size}): it could "
                    "never be matched, only pin dead pages")
        # a re-deploy REPLACES the function: its warm engines serve the old
        # params and its baked prefix was computed under them.  A first
        # deploy over a shared server keeps the host pool another runtime
        # packed for this same function object
        redeploy = fn.name in self.functions
        if redeploy:
            self.evict(fn.name)
        self.release_template_prefix(fn.name)
        self._drop_runtime_prefixes(fn.name)
        self.functions[fn.name] = fn
        self.server.register(fn, example_event or {},
                             template_prompt=template_prompt,
                             keep_host_pool=not redeploy)
        if template_prompt is not None:
            self._baked_events[fn.name] = dict(example_event or {})
            # the deploy-time bake is on the first instance; the others
            # bake the first time the function forks onto them
            self._bake_template_prefix(fn.name, self.instances[0])
        if self.prewarm and not fn.model.is_encdec:
            # enc-dec serves through the sequential Engine only, so there
            # are no continuous-engine entry points to warm (as in the JAX
            # runtime); its invocations raise where that engine is built.
            # One zero-filled parameter set per device (per rank group
            # under a plan), built on first need
            zeros = functools.cache(
                lambda device, group: zero_params(self.server.model_on(
                    fn.name, device,
                    None if group is None else self.instances[group].plan)))
            self._fn_keys[fn.name] = self._prewarm_engine_fns(
                fn, prewarm_seq, zeros)
            if template_prompt is not None or (
                    self.chunk_tokens is not None
                    and fn.model.supports_paged_kv):
                # suffix prefills and chunks run prefill_from at
                # page-multiple lengths: warm exactly those buckets
                self._fn_keys[fn.name] += self._prewarm_suffix_fns(fn, zeros)
            self.workers.prewarm_for_functions(self._fn_keys)

    # ------------------------------------------------------------------
    def _prefix_key(self, fn_name: str, inst: _Instance,
                    event: Optional[dict]) -> tuple:
        """Bake identity: static functions share one bake per instance,
        dynamic ones bake per event (the event's dynamic weights change
        the KV)."""
        fn = self.functions[fn_name]
        ekey = () if fn.static else tuple(sorted(dict(event or {}).items()))
        return (fn_name, inst.idx, ekey)

    def _bake_template_prefix(self, fn_name: str, inst: _Instance,
                              params_fn=None,
                              event: Optional[dict] = None) -> None:
        """Prefill the function's template prompt once and pin its KV pages
        in the instance's shared arena, registering the prefix for
        admission-time matching.  ``params_fn`` supplies already-forked params (the engine
        being built), so a per-event bake does not stream the model a
        second time; without it (the deploy-time bake) it forks its own."""
        if fn_name not in self._baked_events:
            return
        if event is None:
            event = self._baked_events[fn_name]
        key = self._prefix_key(fn_name, inst, event)
        prompt = self.server.template_prompts.get(fn_name)
        if key in self._prefix_handles or prompt is None:
            return
        model = self._model_on(fn_name, inst)
        pool = self._pool_for(model, inst)
        if params_fn is not None:
            params = params_fn()
        else:
            params = self._fork(fn_name, dict(event), inst)[0].params()
        _, cache = model.prefill(
            params, {"tokens": prompt[None, :]},
            model.make_cache(1, pool.padded_len))
        handle = pool.bake_prefix(cache, prompt)
        self._prefix_indexes.setdefault(key, PrefixIndex(self.page_size)
                                        ).register(handle)
        self._prefix_handles[key] = handle

    def _prefix_index_for(self, fn_name: str, event: Optional[dict],
                          inst: _Instance,
                          params_fn=None) -> Optional[PrefixIndex]:
        """The prefix index an engine of (function, event) consults on
        instance ``inst``; a dynamic function bakes its template lazily
        per (event, instance)."""
        if fn_name in self._baked_events:
            self._bake_template_prefix(fn_name, inst, params_fn=params_fn,
                                       event=event)
        return self._prefix_indexes.get(self._prefix_key(fn_name, inst,
                                                         event))

    def release_template_prefix(self, fn_name: str) -> int:
        """Unpin the function's baked prefix pages on every instance (they
        free once no live slot aliases them) and stop baking.  Returns handles dropped."""
        self._baked_events.pop(fn_name, None)
        keys = [k for k in self._prefix_handles if k[0] == fn_name]
        for k in keys:
            handle = self._prefix_handles.pop(k)
            index = self._prefix_indexes.get(k)
            if index is not None:
                index.unregister(handle)
            handle.pool.release_prefix(handle)
        return len(keys)

    # ------------------------------------------------------------------
    # runtime-learned prefixes and predictive prewarm (control-plane hooks)
    # ------------------------------------------------------------------
    def attach_control_plane(self, control_plane) -> None:
        """Bind a ControlPlane: the gateway feeds it arrivals and
        completions and ticks its actuators, and ``_prune`` consults its
        per-function keep-alive."""
        control_plane.bind(self)

    def runtime_prefix_nbytes(self, fn_name: str, n_tokens: int) -> int:
        """Pinned bytes a runtime bake of ``n_tokens`` would cost on the
        function's preferred instance (the control plane budgets before it
        bakes)."""
        inst = self._pick_instance(fn_name)
        pool = self._pool_for(self._model_on(fn_name, inst), inst)
        return pool.blocks_for(n_tokens) * pool.page_nbytes()

    def _params_for_bake(self, fn_name: str, inst: _Instance, ekey: tuple,
                         event: dict):
        """Params to prefill a runtime bake under on instance ``inst``: a
        live warm engine's there (static functions accept any event's
        engine) or a fresh fork's."""
        fn = self.functions[fn_name]
        for k, w in self._engines.items():
            if k[0] == fn_name and w.instance == inst.idx and (
                    fn.static or k[1] == ekey):
                return w.engine.params()
        return self._fork(fn_name, dict(event), inst)[0].params()

    def bake_runtime_prefix(self, fn_name: str, tokens,
                            event: Optional[dict] = None):
        """Bake an OBSERVED hot prompt prefix into pinned arena pages.

        ``tokens`` (page-aligned, at least one page, leaving suffix room
        within ``max_len``) prefill once; the pages are pinned and
        registered in the function's prefix index, so live warm engines
        of the same bake identity match at once and later forks pick the
        index up.  Returns the PrefixHandle, or None when an existing bake
        (template or learned) already covers ``tokens``."""
        if fn_name not in self.functions:
            raise KeyError(f"function {fn_name!r} is not deployed")
        if fn_name in self._adapter_fns:
            raise ValueError(
                f"{fn_name}: adapter functions share a mixed-adapter "
                "engine; their baked KV would be adapter-specific")
        fn = self.functions[fn_name]
        if not fn.model.supports_paged_kv:
            raise ValueError(
                f"{fn_name}: runtime prefixes need a paged attention "
                f"family (got {fn.model.cfg.family!r})")
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = len(tokens)
        if n < self.page_size or n % self.page_size:
            raise ValueError(
                f"{fn_name}: runtime prefix length {n} must be a "
                f"non-zero multiple of the page size ({self.page_size})")
        if n > self.max_len - 1:
            raise ValueError(
                f"{fn_name}: runtime prefix of {n} tokens leaves no "
                f"suffix room within max_len={self.max_len}")
        event = dict(event or {})
        inst = self._pick_instance(fn_name)
        key = self._prefix_key(fn_name, inst, event)
        index = self._prefix_indexes.get(key)
        if index is not None:
            # probe with one sentinel token appended: a full-length match
            # means an existing bake already covers every token
            probe = np.concatenate([tokens, np.asarray([-1], np.int32)])
            hit = index.match(probe)
            if hit is not None and hit[1] >= n:
                return None
        model = self._model_on(fn_name, inst)
        pool = self._pool_for(model, inst)
        params = self._params_for_bake(fn_name, inst, key[2], event)
        _, cache = model.prefill(
            params, {"tokens": tokens[None, :]},
            model.make_cache(1, pool.padded_len))
        handle = pool.bake_prefix(cache, tokens)
        index = self._prefix_indexes.setdefault(key, PrefixIndex(self.page_size))
        index.register(handle)
        self._runtime_prefix_handles.setdefault(key, []).append(handle)
        for k, w in self._engines.items():
            if (k[0] == fn_name and w.instance == inst.idx
                    and (() if fn.static else k[1]) == key[2]):
                w.engine.prefix_index = index
        return handle

    def release_runtime_prefix(self, handle) -> None:
        """Evict one learned prefix: unregister it from matching and drop
        its pin.  Pages a live slot still borrows free when that borrower
        releases; fresh requests stop matching at once."""
        for key in list(self._runtime_prefix_handles):
            handles = self._runtime_prefix_handles[key]
            if not any(h is handle for h in handles):
                continue
            handles[:] = [h for h in handles if h is not handle]
            if not handles:
                del self._runtime_prefix_handles[key]
            index = self._prefix_indexes.get(key)
            if index is not None:
                index.unregister(handle)
            break
        if handle.pinned:
            handle.pool.release_prefix(handle)

    def _drop_runtime_prefixes(self, fn_name: Optional[str] = None) -> int:
        """Release every learned prefix of ``fn_name`` (or all): their KV
        was computed under params a re-deploy is about to replace."""
        keys = [k for k in self._runtime_prefix_handles
                if fn_name is None or k[0] == fn_name]
        n = 0
        for key in keys:
            for handle in self._runtime_prefix_handles.pop(key):
                index = self._prefix_indexes.get(key)
                if index is not None:
                    index.unregister(handle)
                if handle.pinned:
                    handle.pool.release_prefix(handle)
                n += 1
        return n

    def prewarm_function(self, fn_name: str, event: Optional[dict] = None,
                         now: Optional[float] = None) -> bool:
        """Pre-fork an engine ahead of a forecast arrival.  Returns True
        when a new engine was created (False: one was already resident)."""
        now = time.perf_counter() if now is None else now
        if fn_name not in self.functions:
            raise KeyError(f"function {fn_name!r} is not deployed")
        n_before = len(self._engines)
        self._engine_for(fn_name, event, now)
        return len(self._engines) > n_before

    def _count(self, fn_name: str, field: str, n: int = 1) -> None:
        """Bump one per-function service-class counter."""
        d = self.fn_stats.setdefault(fn_name, {})
        d[field] = d.get(field, 0) + n

    def stats(self) -> dict:
        """Per-function service-class counters (cold/fork/warm admission
        kinds; terminal done/reuse_hits/shed/failed/cancelled/rejected)
        with derived rates, each instance's device and warm engines, the
        gateway's supervision stats and, when one is attached, the control
        plane's."""
        fns = {}
        for fn_name, c in self.fn_stats.items():
            d = dict(c)
            admitted = sum(c.get(k, 0) for k in KINDS)
            d["admitted"] = admitted
            if admitted:
                d["warm_rate"] = c.get("warm", 0) / admitted
                d["cold_start_rate"] = (c.get("fork", 0)
                                        + c.get("cold", 0)) / admitted
            if c.get("done"):
                d["reuse_hit_rate"] = c.get("reuse_hits", 0) / c["done"]
            fns[fn_name] = d
        out = {"functions": fns,
               "instances": [{"idx": inst.idx, "device": str(inst.device),
                              "ranks": list(inst.ranks),
                              "engines": self._load(inst)}
                             for inst in self.instances],
               "gateway": dict(self.gateway.stats)}
        if self.control_plane is not None:
            out["control_plane"] = dict(self.control_plane.stats)
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _sync(device: torch.device) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _prewarm_engine_fns(self, fn: LLMFunction, seq: int, zeros) -> list:
        """Run the model's prefill (at ``seq``) and the pool-shaped decode
        once on zero-filled inputs (``zeros(device)``) on every instance,
        counted in the ExecutableCache (one warm-up per model, shape and
        instance, shared across the model's functions)."""
        paged = fn.model.supports_paged_kv
        bps = -(-self.max_len // self.page_size)
        prefill_len = bps * self.page_size if paged else self.max_len
        keys = []
        for inst in self.instances:
            model, dev = self._model_on(fn.name, inst), inst.device
            kp = (id(fn.model), "prefill", inst.idx, 1, seq, self.max_len)
            kd = (id(fn.model), "decode-pool", inst.idx, self.n_slots,
                  self.max_len)

            def host_zeros(shape, dev=dev, plan=inst.plan):
                # under a plan a host batch, which every rank uploads
                z = np.zeros(shape, np.int32)
                return z if plan is not None else torch.as_tensor(z, device=dev)

            def warm_prefill(model=model, dev=dev, inst=inst,
                             host_zeros=host_zeros):
                model.prefill(zeros(dev, _group(inst)),
                              {"tokens": host_zeros((1, seq))},
                              model.make_cache(1, prefill_len))
                self._sync(dev)
                return model.prefill

            def warm_decode(model=model, dev=dev, inst=inst,
                            host_zeros=host_zeros):
                toks = host_zeros((self.n_slots, 1))
                pos = host_zeros((self.n_slots,))
                if paged:
                    cache = model.make_paged_cache(1 + self.n_slots * bps,
                                                   self.page_size,
                                                   kv_dtype=self.kv_dtype)
                    pt = host_zeros((self.n_slots, bps))
                    model.decode_step_paged(zeros(dev, _group(inst)), cache,
                                            {"tokens": toks}, pos, pt,
                                            self.page_size)
                else:
                    model.decode_step(zeros(dev, _group(inst)),
                                      model.make_cache(self.n_slots,
                                                       self.max_len),
                                      {"tokens": toks}, pos)
                self._sync(dev)
                return model.decode_step_paged if paged else model.decode_step

            self.exe_cache.get_or_compile(kp, warm_prefill)
            self.exe_cache.get_or_compile(kd, warm_decode)
            keys += [kp, kd]
        return keys

    def _prewarm_suffix_fns(self, fn: LLMFunction, zeros) -> list:
        """Warm the suffix-only prefill the engine buckets every reuse hit
        onto (``bucket_suffix``): one key per page-multiple suffix length,
        as the JAX package compiles one executable per bucket.  Eager
        PyTorch compiles nothing per shape, so only the first bucket runs
        (paying the lazy loads of ``prefill_from``'s kernels); the others
        are recorded, keeping the cache's hits and misses equal to JAX's."""
        if not fn.model.supports_paged_kv:
            return []
        ps = self.page_size
        bps = -(-self.max_len // ps)
        out = []
        for inst in self.instances:
            model, dev = self._model_on(fn.name, inst), inst.device

            def warm(model=model, dev=dev, inst=inst):
                toks = np.zeros((1, ps), np.int32)
                if inst.plan is None:
                    toks = torch.as_tensor(toks, device=dev)
                model.prefill_from(zeros(dev, _group(inst)), {"tokens": toks},
                                   model.make_cache(1, bps * ps), 0)
                self._sync(dev)
                return model.prefill_from

            keys = [(id(fn.model), "prefill-from", inst.idx, k * ps,
                     self.max_len) for k in range(1, bps + 1)]
            self.exe_cache.get_or_compile(keys[0], warm)
            for key in keys[1:]:
                self.exe_cache.get_or_compile(
                    key, lambda model=model: model.prefill_from)
            out += keys
        return out

    # ------------------------------------------------------------------
    # many functions on one resident engine (shared base + adapter bank)
    # ------------------------------------------------------------------
    def deploy_shared_base(self, fn: LLMFunction, n_adapters: int = 8,
                           rank: int = 4,
                           target_paths: tuple = ("blocks.attn.wq",),
                           example_event: Optional[dict] = None,
                           prewarm_seq: int = 32) -> None:
        """Deploy ``fn`` as a SHARED BASE: one resident engine per
        instance carries an adapter bank of ``n_adapters - 1`` loadable
        rows (row 0 is the null adapter), and every function attached
        with :meth:`attach_adapter` decodes in that engine's batch.  The
        bank targets the attention projections in ``target_paths``; under
        a plan every rank of the instance builds its shard of it."""
        check_bank_config(fn.model, target_paths, n_adapters)
        if not fn.model.supports_paged_kv:
            raise ValueError(
                f"{fn.name}: shared-base serving needs the paged arena")
        self.deploy(fn, example_event, prewarm_seq=prewarm_seq)
        self._shared_bases[fn.name] = {
            "n_adapters": int(n_adapters), "rank": int(rank),
            "targets": tuple(target_paths)}

    def attach_adapter(self, fn_name: str, base_name: str, adapter,
                       alpha: float = 1.0) -> None:
        """Register ``fn_name`` as an adapter function over ``base_name``.

        ``adapter`` is a ``lora_checkpoint``-layout Checkpoint; its factors
        load into the shared engine's bank on the function's first
        invocation.  Invoking it routes to the base's resident engine with
        its bank row as the per-slot adapter id."""
        if base_name not in self._shared_bases:
            raise KeyError(
                f"{base_name!r} is not a shared base (deploy_shared_base)")
        if fn_name in self._shared_bases:
            raise ValueError(f"{fn_name!r} already names a shared base")
        base = self.functions[base_name]
        self.functions[fn_name] = dataclasses.replace(base, name=fn_name)
        self._adapter_fns[fn_name] = (base_name, adapter, float(alpha))

    def _shared_engine_for(self, fn_name: str, now: float) -> tuple:
        """Resolve an adapter function to its base's resident engine,
        creating it (bank and all) on first use and loading the function's
        factors into a free bank row on its first invocation."""
        base_name, adapter, alpha = self._adapter_fns[fn_name]
        cfg = self._shared_bases[base_name]
        inst = self._pick_instance(base_name)
        key = ("__adapters__", base_name, inst.idx)
        warm = self._engines.get(key)
        stats = None
        if warm is None:
            kind = "fork" if base_name in self._invoked else "cold"
            model = self._model_on(base_name, inst)
            session, stats = self._fork(base_name, {}, inst)
            bank = make_adapter_bank(model, cfg["targets"], cfg["n_adapters"],
                                     cfg["rank"])
            engine = ContinuousBatchingEngine(
                model, session, max_len=self.max_len,
                page_size=self.page_size, pool=self._pool_for(model, inst),
                bucket_suffix=True, chunk_tokens=self.chunk_tokens,
                adapter_bank=bank,
                owner_name=f"adapters:{base_name}@{inst.idx}")
            # no prefix index: baked KV is adapter-specific, and this
            # engine's batch mixes adapters
            warm = _WarmEngine(engine, now, inst.idx)
            self._engines[key] = warm
            self._invoked.add(base_name)
        else:
            kind = "warm"
        aid = warm.adapter_ids.get(fn_name)
        if aid is None:
            n = cfg["n_adapters"]
            if warm.next_adapter_id >= n:
                raise RuntimeError(
                    f"{base_name}: adapter bank is full "
                    f"({n - 1} rows, row 0 reserved for the null adapter)")
            aid = warm.next_adapter_id
            warm.next_adapter_id += 1
            warm.engine.set_adapter(aid, adapter, alpha=alpha)
            warm.adapter_ids[fn_name] = aid
            if kind == "warm":
                kind = "fork"        # the first hit pays the factor load
        self._invoked.add(fn_name)
        return key, warm.engine, kind, stats

    def _adapter_id_for(self, fn_name: str, engine_key: tuple) -> int:
        """The bank row a request of ``fn_name`` decodes under (0, the
        null adapter, for every non-adapter function)."""
        if fn_name not in self._adapter_fns:
            return 0
        return self._engines[engine_key].adapter_ids[fn_name]

    # ------------------------------------------------------------------
    def warm_engines(self) -> list:
        return sorted(self._engines)

    def _drop_engine(self, key: tuple) -> None:
        """Remove one warm engine, returning every slot and page it holds
        to the shared pool and retiring its partition lease."""
        self._engines.pop(key).engine.close()

    def evict(self, fn_name: Optional[str] = None) -> int:
        """Drop warm engines (all of ``fn_name``'s, or every one): the next
        invocation takes the fork path again (keep-alive expiry)."""
        keys = [k for k in self._engines
                if fn_name is None or k[0] == fn_name
                or (k[0] == "__adapters__" and k[1] == fn_name)]
        for k in keys:
            self._drop_engine(k)
        return len(keys)

    def _keep_alive_for(self, key: tuple, now: float) -> float:
        """Keep-alive window of one engine key: the static default, or the
        attached control plane's predictive per-function value."""
        if self.control_plane is None:
            return self.keep_alive_s
        return self.control_plane.keep_alive_s_for(key[0], self.keep_alive_s,
                                                   now=now)

    def _prune(self, now: float) -> None:
        """Keep-alive expiry and the LRU cap, over IDLE engines only: an
        engine with pending work serves someone's ticket (``evict()``
        stays the explicit force-drop)."""
        idle = [k for k, w in self._engines.items() if not w.engine.n_pending]
        for k in [k for k in idle
                  if now - self._engines[k].last_used_s
                  > self._keep_alive_for(k, now)]:
            idle.remove(k)
            self._drop_engine(k)
        while len(self._engines) > self.max_warm_engines and idle:
            oldest = min(idle, key=lambda k: self._engines[k].last_used_s)
            idle.remove(oldest)
            self._drop_engine(oldest)

    def _load(self, inst: _Instance) -> int:
        """Warm engines on instance ``inst``."""
        return sum(1 for w in self._engines.values() if w.instance == inst.idx)

    def _pick_instance(self, fn_name: str) -> _Instance:
        """Locality routing across instances, the live analogue of
        ``ClusterSim._pick_gpu``: prefer an instance already warm for this
        function (its pool and entry points are hot) unless it holds more
        than ``locality_max_extra_load`` engines over the least-loaded
        instance."""
        if len(self.instances) == 1:
            return self.instances[0]
        best_any = min(self.instances, key=lambda i: (self._load(i), i.idx))
        warm_idx = {w.instance for k, w in self._engines.items()
                    if k[0] == fn_name}
        if warm_idx:
            cands = [i for i in self.instances if i.idx in warm_idx]
            best_warm = min(cands, key=lambda i: (self._load(i), i.idx))
            if (self._load(best_warm) - self._load(best_any)
                    <= self.locality_max_extra_load):
                return best_warm
        return best_any

    def _engine_for(self, fn_name: str, event: Optional[dict],
                    now: float) -> tuple:
        """Resolve (key, engine, kind, fork stats) for one invocation,
        forking a new engine when no warm one exists."""
        if fn_name not in self.functions:
            raise KeyError(f"function {fn_name!r} is not deployed")
        if fn_name in self._adapter_fns:
            return self._shared_engine_for(fn_name, now)
        key = _engine_key(fn_name, event or {})
        warm = self._engines.get(key)
        if warm is not None:
            self._invoked.add(fn_name)
            return key, warm.engine, "warm", None
        kind = "fork" if fn_name in self._invoked else "cold"
        inst = self._pick_instance(fn_name)
        model = self._model_on(fn_name, inst)
        session, stats = self._fork(fn_name, event or {}, inst)
        engine = ContinuousBatchingEngine(
            model, session, max_len=self.max_len, page_size=self.page_size,
            pool=self._pool_for(model, inst), bucket_suffix=True,
            chunk_tokens=self.chunk_tokens, owner_name=f"{fn_name}@{inst.idx}")
        # a lazy per-(event, instance) bake reuses THIS fork's params
        engine.prefix_index = self._prefix_index_for(fn_name, event, inst,
                                                     params_fn=engine.params)
        self._engines[key] = _WarmEngine(engine, now, inst.idx)
        self._invoked.add(fn_name)
        return key, engine, kind, stats

    def observe_ttft(self, fn_name: str, ttft_s: float) -> None:
        """Route Eq. 1 TTFT feedback to the template server; adapter
        functions credit their base's template."""
        name = self._adapter_fns.get(fn_name, (fn_name,))[0]
        self.server.observe_ttft(name, ttft_s)

    def _validate(self, fn_name: str, prompt, max_new_tokens: int) -> None:
        """Reject what could never serve before it touches any engine."""
        if fn_name not in self.functions:
            raise KeyError(f"function {fn_name!r} is not deployed")
        plen = len(np.asarray(prompt).reshape(-1))
        if max_new_tokens < 1 or plen + max_new_tokens > self.max_len:
            raise ValueError(
                f"{fn_name}: prompt({plen}) + max_new({max_new_tokens}) "
                f"exceeds runtime max_len={self.max_len}")

    def submit(self, request, event: Optional[dict] = None, prompt=None,
               max_new_tokens: int = 8, *, temperature: float = 0.0,
               top_p: float = 1.0, seed: int = 0):
        """Invoke a deployed function.

        With an :class:`InvocationRequest`, returns an
        :class:`InvocationHandle` ticket at once.  The positional form
        ``submit(fn_name, event, prompt, max_new_tokens, ...)`` submits
        through the same gateway, drains it and returns the
        :class:`SubmitResult`."""
        if isinstance(request, InvocationRequest):
            return self.gateway.submit(request)
        return self.submit_many([(request, event, prompt, max_new_tokens,
                                  temperature, top_p, seed)])[0]

    def submit_async(self, request: InvocationRequest) -> InvocationHandle:
        """Explicitly named alias of the async ``submit`` form."""
        return self.gateway.submit(request)

    def submit_many(self, requests: list) -> list:
        """Batch shim over the gateway: ``(fn_name, event, prompt,
        max_new_tokens[, temperature[, top_p[, seed]]])`` tuples, all
        ticketed before any engine steps, so requests of one engine share
        decode batches."""
        parsed = []
        for req in requests:
            fn_name, event, prompt, max_new_tokens = req[:4]
            extra = tuple(req[4:])
            parsed.append(InvocationRequest(
                fn_name=fn_name, prompt=prompt, event=event,
                max_new_tokens=max_new_tokens,
                temperature=extra[0] if len(extra) > 0 else 0.0,
                top_p=extra[1] if len(extra) > 1 else 1.0,
                seed=extra[2] if len(extra) > 2 else 0))
        # validate the whole batch before touching any engine
        for r in parsed:
            self._validate(r.fn_name, r.prompt, r.max_new_tokens)
        worker = self.workers.acquire()                      # §5.1 pool
        try:
            handles = [self.gateway.submit(r) for r in parsed]
            self.gateway.drain()
            return [h.result() for h in handles]
        finally:
            if worker is not None:
                self.workers.release(worker)


# ---------------------------------------------------------------------------
# measured service times -> cluster-scheduler oracle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeasuredServiceTimes:
    """Wall-clock warm/fork/cold service times per function, LENGTH-
    BUCKETED: each kind maps to measurements at one or more prompt lengths
    and ``service_s`` linearly interpolates between buckets (clamping
    outside the measured range), so the scheduler's per-request
    ``input_len`` actually changes the oracle's answer.

    Satisfies the duck-typed ``SchedulerConfig.measured`` hook of the
    port's cluster scheduler (``repro_torch.core.scheduler``): the sim
    calls ``service_s(fn_name, kind, input_len)`` and falls back to the
    analytic cost model whenever this returns None.  ``"*"`` is a wildcard
    function entry.  ``times`` values may be plain floats (one bucket) or
    ``[(input_len, seconds), ...]`` lists."""
    times: dict                  # fn_name -> {kind: float | [(len, s), ...]}
    measured_prompt_len: Optional[int] = None

    def _buckets(self, fn_name: str, kind: str):
        d = self.times.get(fn_name) or self.times.get("*")
        if d is None or kind not in d:
            return None
        v = d[kind]
        if isinstance(v, (int, float)):
            return [(self.measured_prompt_len or 0, float(v))]
        return sorted((int(length), float(s)) for length, s in v)

    def service_s(self, fn_name: str, kind: str,
                  input_len: Optional[int] = None) -> Optional[float]:
        pts = self._buckets(fn_name, kind)
        if pts is None:
            return None
        if input_len is None or len(pts) == 1:
            return pts[0][1]
        xs = np.asarray([p[0] for p in pts], np.float64)
        ys = np.asarray([p[1] for p in pts], np.float64)
        return float(np.interp(float(input_len), xs, ys))

    def summary(self) -> str:
        rows = []
        for fn, d in sorted(self.times.items()):
            parts = []
            for k in KINDS:
                pts = self._buckets(fn, k)
                if pts is None:
                    continue
                parts.append(k + "=" + "/".join(
                    f"{s*1e3:.1f}ms@{length}" for length, s in pts))
            rows.append(fn + ": " + " ".join(parts))
        return "\n".join(rows)


def measure_service_times(runtime: FaaSRuntime, fn_events: dict,
                          prompt_len: int = 16, max_new_tokens: int = 4,
                          warm_reps: int = 2, seed: int = 0,
                          prompt_lens: Optional[list] = None
                          ) -> MeasuredServiceTimes:
    """Exercise each function's cold, fork and warm paths on the REAL
    runtime and record wall-clock service times.

    ``fn_events``: {fn_name: event dict}.  Functions already invoked on this
    runtime report their first measurement under the kind the runtime
    actually took (fork), not cold.  The warm figure is the best of
    ``warm_reps`` repeats: the first warm hit on a fresh engine may still
    pay one-off lazy compilation, which is a compile artifact, not the
    steady-state warm service time the scheduler models.

    ``prompt_lens`` turns on LENGTH BUCKETING: the fork/warm dance repeats
    at every bucket length and the oracle interpolates between them (cold
    can only ever happen once per function, so it stays a single point)."""
    rng = np.random.default_rng(seed)
    lens = sorted(set(prompt_lens or [prompt_len]))
    times: dict = {}
    for fn_name, event in fn_events.items():
        vocab = runtime.functions[fn_name].model.cfg.vocab_size
        per: dict = {}

        def record(kind: str, length: int, seconds: float):
            pts = per.setdefault(kind, [])
            for i, (L, s) in enumerate(pts):
                if L == length:
                    pts[i] = (L, min(s, seconds))
                    return
            pts.append((length, seconds))

        for j, L in enumerate(lens):
            prompt = rng.integers(0, vocab, L).astype(np.int32)
            first = runtime.submit(fn_name, event, prompt, max_new_tokens)
            record(first.kind, L, first.ttft_s)         # cold at 1st bucket
            runtime.evict(fn_name)                      # expire keep-alive
            forked = runtime.submit(fn_name, event, prompt, max_new_tokens)
            if forked.kind not in per or j > 0:
                record(forked.kind, L, forked.ttft_s)   # fork per bucket
            for _ in range(max(1, warm_reps)):
                warm = runtime.submit(fn_name, event, prompt, max_new_tokens)
                record(warm.kind, L, warm.ttft_s)
        times[fn_name] = per
    return MeasuredServiceTimes(times, measured_prompt_len=lens[0])


def measure_smoke_service_times(functions: dict, arch: str = "smollm-135m",
                                n_layers: int = 2, n_slots: int = 2,
                                max_len: int = 32, trace_seq: int = 16,
                                prompt_len: int = 16, max_new_tokens: int = 4,
                                seed: int = 0, mesh=None,
                                device="cuda") -> MeasuredServiceTimes:
    """One-stop live measurement rig for the ``--measured`` demos
    (``examples/torch_faas_cluster.py``): build a smoke-scale runtime on
    ``device`` (the card by default; ``device="cpu"`` on the CPU), deploy
    one variant per ``functions`` entry ({name: 'static' | 'lora'}) and
    measure cold/fork/warm wall-clock service times for each."""
    model = get_smoke_model(arch, device=device, n_layers=n_layers)
    rt = FaaSRuntime(n_slots=n_slots, max_len=max_len, trace_seq=trace_seq,
                     mesh=mesh, device=device)
    params = model.init_params(seed=seed)
    events: dict = {}
    for name, kind in functions.items():
        if kind == "lora":
            rt.deploy(tidal.lora_function(name, model, params,
                                          ["blocks.attn.wq"], n_adapters=2),
                      {"adapter": "adapter-0"}, prewarm_seq=prompt_len)
            events[name] = {"adapter": "adapter-1"}
        elif kind == "static":
            rt.deploy(tidal.static_function(name, model, params), {},
                      prewarm_seq=prompt_len)
            events[name] = {}
        else:
            raise ValueError(f"{name}: unknown function kind {kind!r}")
    return measure_service_times(rt, events, prompt_len=prompt_len,
                                 max_new_tokens=max_new_tokens)
