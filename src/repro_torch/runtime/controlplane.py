"""Predictive prewarm control plane with a runtime-learned prefix cache.

The port of ``repro.runtime.controlplane``: host-only policy code, carried
over whole over the port's own errors and gateway requests.

The serving stack below this module is entirely *mechanism*: templates
fork cheaply, :class:`~repro_torch.runtime.prefix.PrefixIndex` serves baked
prompt-prefix KV copy-on-write, and keep-alive expiry is a fixed decay.
Policy, until now, was static — template prompts were the only prefixes
ever baked, and every engine lived exactly ``keep_alive_s`` past its last
use.  This module closes the loop with two coupled halves driven by the
gateway's observation stream:

* **Runtime-learned prefix cache** — :class:`PrefixObserver` mines hot
  page-aligned prompt prefixes (shared few-shot preambles, RAG headers,
  conversation roots — not just deploy-time templates) from per-admission
  observations, and the control plane bakes the winners into the arena
  via ``FaaSRuntime.bake_runtime_prefix`` under a pinned-bytes budget
  with a frequency×recency eviction score.  Page refcounts already make
  unpinning safe: evicting a prefix with live borrowers only unregisters
  it from matching; its pages free when the last borrower releases.

* **Arrival forecasting + prewarm policy** — :class:`ArrivalPredictor`
  (default :class:`EwmaHistogramPredictor`: EWMA rate + an inter-arrival
  histogram survival estimate; a learned model per arxiv 2504.11338 can
  drop in behind the same interface) drives the actuators: pre-fork
  engines ahead of forecast arrivals, extend keep-alive for functions
  predicted to recur, and release early for ones predicted idle —
  replacing pure keep-alive decay.

Wiring::

    gateway.submit ──> on_arrival ──> ArrivalPredictor   (observe)
    handle._finalize ─> on_completion ─> PrefixObserver  (observe)
    gateway._round / replay ──> maybe_tick ──> tick      (actuate)
        tick: bake nominated prefixes (budgeted, evicting by score)
              prewarm functions with imminent forecast arrivals
              _prune with per-function predictive keep-alive

Cluster-simulator traces are the training/eval substrate: the same
recorded trace (a JSONL file of ``core.scheduler.export_trace``, read back
by ``import_trace``) replays through the port's simulator
(``core.scheduler.ClusterSim``) for policy search and, via
:func:`trace_schedule`, through ``InvocationGateway.replay`` for the
measured gate.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.runtime.errors import PoolExhausted, RuntimeFailure
from repro_torch.runtime.gateway import InvocationRequest


class ArrivalPredictor:
    """Pluggable per-function arrival forecaster interface.

    The control plane only ever calls these four methods, so a learned
    model (e.g. the transformer invocation predictor of arxiv
    2504.11338, trained offline on exported ``ClusterSim`` traces) can
    replace the default :class:`EwmaHistogramPredictor` without touching
    any actuator code.  Timestamps are ``time.perf_counter``-based — the
    same clock the gateway stamps arrivals with.
    """

    def observe(self, fn_name: str, t: float) -> None:
        """Record one arrival of ``fn_name`` at time ``t``."""
        raise NotImplementedError

    def rate(self, fn_name: str, now: float) -> float:
        """Estimated arrival rate (requests/s) of ``fn_name`` at ``now``."""
        raise NotImplementedError

    def next_eta(self, fn_name: str, now: float) -> Optional[float]:
        """Seconds until the next forecast arrival (None = no forecast)."""
        raise NotImplementedError

    def p_within(self, fn_name: str, now: float, horizon_s: float) -> float:
        """Probability of at least one arrival within ``horizon_s``."""
        raise NotImplementedError

    def functions(self) -> list:
        """Function names this predictor has observed."""
        raise NotImplementedError


class EwmaHistogramPredictor(ArrivalPredictor):
    """EWMA rate + inter-arrival-histogram survival baseline.

    The histogram is the workhorse: with the observed inter-arrival gaps
    ``g_1..g_n`` and ``elapsed`` seconds since the last arrival, the
    next-arrival forecast is the empirical conditional

        P(arrival within h | quiet for elapsed)
            = |{g : elapsed < g <= elapsed + h}| / |{g : g > elapsed}|

    which nails periodic/bursty traffic (the gap histogram concentrates
    at the period) without assuming Poisson.  ``slack`` tolerates jitter:
    a burst arriving up to ``slack``× later than every observed gap still
    counts as alive rather than collapsing the forecast to zero.  The
    EWMA rate is kept for dashboards and coarse admission heuristics.
    """

    def __init__(self, alpha: float = 0.3, max_gaps: int = 256,
                 slack: float = 0.25):
        self.alpha = float(alpha)
        self.slack = float(slack)
        self._last: dict[str, float] = {}
        self._ewma_gap: dict[str, float] = {}
        self._gaps: dict[str, collections.deque] = {}
        self._n: dict[str, int] = {}
        self._max_gaps = int(max_gaps)

    def observe(self, fn_name: str, t: float) -> None:
        """Record one arrival, updating the gap EWMA and histogram."""
        last = self._last.get(fn_name)
        if last is not None and t > last:
            gap = t - last
            prev = self._ewma_gap.get(fn_name)
            self._ewma_gap[fn_name] = (
                gap if prev is None
                else (1 - self.alpha) * prev + self.alpha * gap)
            self._gaps.setdefault(
                fn_name, collections.deque(maxlen=self._max_gaps)).append(gap)
        self._last[fn_name] = max(t, last) if last is not None else t
        self._n[fn_name] = self._n.get(fn_name, 0) + 1

    def n_observations(self, fn_name: str) -> int:
        """Arrivals observed for ``fn_name`` so far."""
        return self._n.get(fn_name, 0)

    def rate(self, fn_name: str, now: float) -> float:
        """EWMA arrival rate in requests/s (0 before two arrivals)."""
        gap = self._ewma_gap.get(fn_name)
        return 1.0 / gap if gap else 0.0

    def _elapsed(self, fn_name: str, now: float) -> Optional[float]:
        last = self._last.get(fn_name)
        if last is None:
            return None
        return max(0.0, now - last) / (1.0 + self.slack)

    def next_eta(self, fn_name: str, now: float) -> Optional[float]:
        """Time to the smallest observed gap still ahead of ``now``."""
        gaps = self._gaps.get(fn_name)
        elapsed = self._elapsed(fn_name, now)
        if not gaps or elapsed is None:
            return None
        ahead = [g for g in gaps if g > elapsed]
        if not ahead:
            return None
        return max(0.0, min(ahead) - elapsed)

    def p_within(self, fn_name: str, now: float, horizon_s: float) -> float:
        """Empirical survival-conditional arrival probability."""
        gaps = self._gaps.get(fn_name)
        elapsed = self._elapsed(fn_name, now)
        if not gaps or elapsed is None:
            return 0.0
        alive = [g for g in gaps if g > elapsed]
        if not alive:
            return 0.0                   # quiet past every observed gap
        hit = sum(1 for g in alive if g <= elapsed + horizon_s)
        return hit / len(alive)

    def functions(self) -> list:
        """Function names with at least one observed arrival."""
        return list(self._last)


@dataclasses.dataclass
class _PrefixNode:
    """One page-chain position in the observer's prefix trie."""

    tokens: np.ndarray               # the prefix itself, page-aligned
    event: dict                      # first-seen event (dynamic-fn bakes)
    count: int = 0
    last_s: float = 0.0
    baked: bool = False


class PrefixObserver:
    """Mines hot page-aligned prompt prefixes from the admission stream.

    Every completed request contributes its prompt's page hash-chain
    (the same chain :class:`~repro_torch.runtime.prefix.PrefixIndex` matches
    on): node ``(fn_key, depth, h_depth)`` counts how many prompts
    shared that exact ``depth``-page prefix.  ``nominate`` returns the
    deepest un-baked nodes with at least ``min_hits`` observations —
    deepest-first, with a nominated node covering its own ancestors for
    the round so one hot conversation root yields one bake, not one per
    depth.  The node table is bounded: past ``max_nodes`` the coldest
    un-baked entries are dropped.
    """

    def __init__(self, page_size: int, min_hits: int = 3,
                 max_pages: int = 64, max_nodes: int = 4096):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = int(page_size)
        self.min_hits = int(min_hits)
        self.max_pages = int(max_pages)
        self.max_nodes = int(max_nodes)
        self._nodes: dict[tuple, _PrefixNode] = {}

    def __len__(self) -> int:
        return len(self._nodes)

    def _chain_keys(self, fn_key, tokens: np.ndarray):
        ps = self.page_size
        n = min(len(tokens) // ps, self.max_pages)
        h = 0
        for k in range(n):
            h = hash((h, tokens[k * ps:(k + 1) * ps].tobytes()))
            yield (fn_key, k + 1, h)

    def observe(self, fn_key, prompt, now: float,
                event: Optional[dict] = None) -> None:
        """Fold one completed prompt into the prefix trie.

        Args:
            fn_key: bake-identity key (the runtime's static functions
                share one key across events; dynamic ones key per event).
            prompt: int32 token ids of the full prompt.
            now: observation timestamp.
            event: the invocation's event dict, kept so a dynamic
                function's bake replays the right weights.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        for key in self._chain_keys(fn_key, prompt):
            node = self._nodes.get(key)
            if node is None:
                if len(self._nodes) >= self.max_nodes:
                    self._prune_nodes()
                depth = key[1]
                node = _PrefixNode(
                    tokens=np.array(prompt[:depth * self.page_size],
                                    np.int32),
                    event=dict(event or {}))
                self._nodes[key] = node
            node.count += 1
            node.last_s = now

    def nominate(self, now: float, limit: int = 1) -> list:
        """Deepest un-baked nodes with ``count >= min_hits``.

        Returns up to ``limit`` ``(node_key, node)`` pairs; a nominated
        node suppresses its ancestor chain positions for this round.
        """
        cands = [(key, node) for key, node in self._nodes.items()
                 if node.count >= self.min_hits and not node.baked]
        # deepest first, count breaking ties: one hot root nominates its
        # longest shared extent, not every intermediate depth
        cands.sort(key=lambda kn: (kn[0][1], kn[1].count, -kn[0][2]),
                   reverse=True)
        out: list = []
        # an already-baked node covers its whole ancestor chain: those
        # extents are served by the deeper bake, so re-nominating them
        # would only burn nomination slots on duplicate-probe rejections
        covered: set = set()
        for key, node in self._nodes.items():
            if node.baked:
                covered.update(self._chain_keys(key[0], node.tokens))
        for key, node in cands:
            if key in covered:
                continue
            out.append((key, node))
            covered.update(self._chain_keys(key[0], node.tokens))
            if len(out) >= limit:
                break
        return out

    def mark_baked(self, node_key: tuple) -> None:
        """Exclude a node from future nomination (baked or hopeless)."""
        node = self._nodes.get(node_key)
        if node is not None:
            node.baked = True

    def forget(self, node_key: tuple) -> None:
        """Reset a node after eviction: it must re-earn ``min_hits``.

        The whole ancestor chain resets with it — a budget eviction must
        not be answered next tick by re-baking a shallower slice of the
        same extent the budget just reclaimed.
        """
        node = self._nodes.get(node_key)
        if node is None:
            return
        for key in self._chain_keys(node_key[0], node.tokens):
            ancestor = self._nodes.get(key)
            if ancestor is not None and not ancestor.baked:
                ancestor.count = 0
        node.count = 0
        node.baked = False

    def node_stats(self, node_key: tuple) -> tuple:
        """``(count, last_s)`` of a node (``(0, -inf)`` if unknown)."""
        node = self._nodes.get(node_key)
        if node is None:
            return (0, float("-inf"))
        return (node.count, node.last_s)

    def _prune_nodes(self) -> None:
        """Drop the coldest un-baked half of the node table."""
        victims = sorted(
            (k for k, n in self._nodes.items() if not n.baked),
            key=lambda k: (self._nodes[k].count, self._nodes[k].last_s))
        for k in victims[:max(1, len(victims) // 2)]:
            del self._nodes[k]


class ControlPlane:
    """Observer → forecaster → actuator loop over one ``FaaSRuntime``.

    Attach with ``ControlPlane(runtime, ...)`` (or
    ``runtime.attach_control_plane(cp)``): the gateway then feeds every
    arrival to the predictor and every completion to the prefix
    observer, and ticks the actuators from its scheduling loop —
    cooperative and single-threaded, so the pump thread stays the only
    thread stepping the engines (on the runtime's card and stream).

    Actuators per tick (rate-limited by ``tick_interval_s``):

    1. bake up to ``max_bakes_per_tick`` nominated hot prefixes, keeping
       total pinned bytes ≤ ``pinned_bytes_budget`` by evicting the
       lowest frequency×recency score first
       (``count × 0.5^(idle/half_life_s)``);
    2. pre-fork engines for functions whose forecast arrival probability
       within ``prewarm_horizon_s`` is ≥ ``prewarm_p``;
    3. run the runtime's ``_prune`` under predictive per-function
       keep-alive: ``extend_factor``× for functions predicted to recur
       past the default window, ``release_factor``× for ones predicted
       idle (``p_within(default) <= release_p`` after
       ``min_observations`` arrivals).
    """

    def __init__(self, runtime=None, *,
                 pinned_bytes_budget: int = 1 << 22,
                 predictor: Optional[ArrivalPredictor] = None,
                 observer: Optional[PrefixObserver] = None,
                 min_hits: int = 3,
                 prewarm_horizon_s: float = 0.25, prewarm_p: float = 0.5,
                 extend_factor: float = 6.0, extend_p: float = 0.5,
                 release_factor: float = 0.25, release_p: float = 0.05,
                 min_observations: int = 4,
                 tick_interval_s: float = 0.02, max_bakes_per_tick: int = 1,
                 half_life_s: float = 30.0):
        self.pinned_bytes_budget = int(pinned_bytes_budget)
        self.predictor = predictor or EwmaHistogramPredictor()
        self.observer = observer
        self.min_hits = int(min_hits)
        self.prewarm_horizon_s = float(prewarm_horizon_s)
        self.prewarm_p = float(prewarm_p)
        self.extend_factor = float(extend_factor)
        self.extend_p = float(extend_p)
        self.release_factor = float(release_factor)
        self.release_p = float(release_p)
        self.min_observations = int(min_observations)
        self.tick_interval_s = float(tick_interval_s)
        self.max_bakes_per_tick = int(max_bakes_per_tick)
        self.half_life_s = float(half_life_s)
        self.stats = {"ticks": 0, "prefix_bakes": 0, "prefix_evictions": 0,
                      "prewarm_forks": 0, "observations": 0}
        self.runtime = None
        self._handles: dict[tuple, object] = {}   # node_key -> PrefixHandle
        self._last_event: dict[str, dict] = {}
        self._last_tick_s = float("-inf")
        if runtime is not None:
            self.bind(runtime)

    # -- wiring ---------------------------------------------------------
    def bind(self, runtime) -> None:
        """Attach to ``runtime`` (also sets ``runtime.control_plane``)."""
        self.runtime = runtime
        if self.observer is None:
            max_pages = max(1, (runtime.max_len - 1) // runtime.page_size)
            self.observer = PrefixObserver(runtime.page_size,
                                           min_hits=self.min_hits,
                                           max_pages=max_pages)
        runtime.control_plane = self

    # -- observation stream (called by the gateway) ---------------------
    def on_arrival(self, fn_name: str, now: float,
                   event: Optional[dict]) -> None:
        """Feed one gateway arrival to the forecaster."""
        self.predictor.observe(fn_name, now)
        self._last_event[fn_name] = dict(event or {})

    def on_completion(self, fn_name: str, event: Optional[dict], prompt,
                      kind: str, reused_prefix_len: int,
                      now: float) -> None:
        """Feed one completed invocation to the prefix observer.

        Every completion counts — including ones that already reused a
        (template or learned) prefix: deeper shared extents keep
        accumulating evidence past the current bake.
        """
        rt = self.runtime
        if rt is None or fn_name in rt._adapter_fns:
            # adapter functions mix per-function weights in one engine;
            # their baked KV would be adapter-specific (see faas.py)
            return
        self.stats["observations"] += 1
        fn = rt.functions.get(fn_name)
        ekey = (() if fn is not None and fn.static
                else tuple(sorted(dict(event or {}).items())))
        self.observer.observe((fn_name, ekey), prompt, now, event=event)

    # -- accounting -----------------------------------------------------
    def pinned_nbytes(self) -> int:
        """Bytes currently pinned by control-plane-baked prefixes.

        Handles unpinned underneath us (re-deploy, manual release) drop
        out of the ledger here; pages a live borrower still aliases are
        the borrower's bytes, not pinned bytes.
        """
        dead = [k for k, h in self._handles.items() if not h.pinned]
        for k in dead:
            self._handles.pop(k)
            self.observer.forget(k)
        return sum(len(h.pages) * h.pool.page_nbytes()
                   for h in self._handles.values())

    def learned_prefixes(self) -> list:
        """Live control-plane-baked ``PrefixHandle``s (test surface)."""
        self.pinned_nbytes()
        return list(self._handles.values())

    def _score(self, node_key: tuple, now: float) -> float:
        """Frequency×recency eviction score (lowest evicts first)."""
        count, last_s = self.observer.node_stats(node_key)
        age = max(0.0, now - last_s)
        return count * 0.5 ** (age / self.half_life_s)

    def _evict_one(self, now: float) -> bool:
        """Evict the lowest-scoring learned prefix; False if none left."""
        if not self._handles:
            return False
        key = min(self._handles, key=lambda k: self._score(k, now))
        handle = self._handles.pop(key)
        self.runtime.release_runtime_prefix(handle)
        self.observer.forget(key)
        self.stats["prefix_evictions"] += 1
        return True

    # -- actuators ------------------------------------------------------
    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """Tick if ``tick_interval_s`` elapsed; returns whether it did."""
        now = time.perf_counter() if now is None else now
        if now - self._last_tick_s < self.tick_interval_s:
            return False
        self.tick(now)
        return True

    def tick(self, now: Optional[float] = None) -> None:
        """Run one actuation round (bake, prewarm, predictive prune)."""
        if self.runtime is None:
            raise RuntimeError("ControlPlane is not bound to a runtime")
        now = time.perf_counter() if now is None else now
        self._last_tick_s = now
        self.stats["ticks"] += 1
        self._bake_nominations(now)
        self._prewarm(now)
        self.runtime._prune(now)

    def _bake_nominations(self, now: float) -> None:
        """Bake nominated prefixes, evicting by score to respect budget."""
        rt = self.runtime
        for node_key, node in self.observer.nominate(
                now, limit=self.max_bakes_per_tick):
            fn_name = node_key[0][0]
            if fn_name not in rt.functions or fn_name in rt._adapter_fns:
                self.observer.mark_baked(node_key)     # never bakeable
                continue
            if not rt.functions[fn_name].model.supports_paged_kv:
                self.observer.mark_baked(node_key)
                continue
            nbytes = rt.runtime_prefix_nbytes(fn_name, len(node.tokens))
            if nbytes > self.pinned_bytes_budget:
                self.observer.mark_baked(node_key)     # can never fit
                continue
            while self.pinned_nbytes() + nbytes > self.pinned_bytes_budget:
                if not self._evict_one(now):
                    break
            if self.pinned_nbytes() + nbytes > self.pinned_bytes_budget:
                continue                               # retry next tick
            try:
                handle = rt.bake_runtime_prefix(fn_name, node.tokens,
                                                event=node.event)
            except (PoolExhausted, RuntimeFailure):
                continue                               # arena pressure
            self.observer.mark_baked(node_key)
            if handle is None:
                continue               # an existing bake already covers it
            self._handles[node_key] = handle
            self.stats["prefix_bakes"] += 1

    def _prewarm(self, now: float) -> None:
        """Pre-fork engines for functions with imminent forecast arrivals."""
        rt = self.runtime
        for fn_name in self.predictor.functions():
            if fn_name not in rt.functions:
                continue
            if any(k[0] == fn_name for k in rt._engines):
                continue                               # already warm
            if fn_name in rt._adapter_fns:
                base = rt._adapter_fns[fn_name][0]
                if any(k[0] == "__adapters__" and k[1] == base
                       for k in rt._engines):
                    continue
            p = self.predictor.p_within(fn_name, now, self.prewarm_horizon_s)
            if p < self.prewarm_p:
                continue
            try:
                if rt.prewarm_function(fn_name,
                                       self._last_event.get(fn_name),
                                       now=now):
                    self.stats["prewarm_forks"] += 1
            except RuntimeFailure:
                continue                               # pool pressure

    def keep_alive_s_for(self, fn_name: str, default_s: float,
                         now: Optional[float] = None) -> float:
        """Predictive keep-alive for ``fn_name`` (called from ``_prune``).

        Extends the window when an arrival is forecast within the
        extended window; shrinks it when the function is predicted idle
        across the default window (only after ``min_observations``
        arrivals — never release early on a cold-start guess).
        """
        now = time.perf_counter() if now is None else now
        p_ext = self.predictor.p_within(fn_name, now,
                                        default_s * self.extend_factor)
        if p_ext >= self.extend_p:
            return default_s * self.extend_factor
        if (isinstance(self.predictor, EwmaHistogramPredictor)
                and self.predictor.n_observations(fn_name)
                < self.min_observations):
            return default_s
        if self.predictor.p_within(fn_name, now, default_s) <= self.release_p:
            return default_s * self.release_factor
        return default_s


def trace_schedule(trace, prompt_for, max_new_tokens: int = 8,
                   event_for=None) -> list:
    """Convert a cluster-simulator trace into a gateway replay schedule.

    The same trace then drives both consumers: the simulator takes the
    record list as-is; the live gateway takes this
    ``[(offset_s, InvocationRequest)]`` view, with deadlines and
    priorities carried through.

    Args:
        trace: the port's ``core.scheduler.SimRequest`` records (any
            record with ``arrival_s``, ``fn_name``, ``deadline_s`` and
            ``priority`` attributes).
        prompt_for: callable ``record -> int32 tokens`` (the sim only
            records ``input_len``; live replay needs real tokens).
        max_new_tokens: decode budget per request.
        event_for: optional callable ``record -> event dict``.

    Returns:
        Schedule consumable by ``InvocationGateway.replay``.
    """
    out = []
    for r in trace:
        out.append((float(r.arrival_s), InvocationRequest(
            fn_name=r.fn_name, prompt=prompt_for(r),
            event=(event_for(r) if event_for is not None else None),
            max_new_tokens=max_new_tokens,
            deadline_s=r.deadline_s, priority=r.priority)))
    return out
