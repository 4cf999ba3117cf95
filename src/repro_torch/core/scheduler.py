"""FaaS cluster scheduler + discrete-event simulator (TIDAL §6 prototype,
evaluated in §7.3 with real-world traces): the port's copy of
``repro.core.scheduler``.

Features mirrored from the paper's 840-line scheduler prototype:
  * keep-alive of launched instances for a configurable interval;
  * keep-alive for DYNAMIC functions via adaptive forking (Tidal-DK): static
    weights persist, only the adapter re-initializes;
  * early-reject of requests whose queueing delay exceeds the timeout;
  * locality routing (prefer the GPU already holding the function's
    template / warm instance);
  * per-GPU HBM accounting with LRU eviction of expired instances;
  * per-function template budgets (Tidal-DK-6G: Eq. 1-guided).

Large-scale runnability features beyond the paper:
  * elastic scaling — GPUs can join/leave mid-trace (``capacity_events``);
  * straggler mitigation — requests queued past ``hedge_after`` are hedged
    onto the least-loaded other GPU, first completion wins.

Latencies come from the analytical cost model (calibrated against the
paper's testbed, ``hw.A6000_PCIE4`` by default as in the reference, so
that the two simulators can be held equal); the simulator itself is exact
discrete-event bookkeeping.  In MEASURED mode
(``SchedulerConfig.measured``) the warm/fork/cold service times are
instead sourced from wall-clock measurements of the port's serving
runtime (``repro_torch.runtime.faas.measure_service_times``, on the card
its hand-written kernels), with the analytic oracle as fallback for
anything unmeasured — closing the sim-vs-real loop.  Traces are the
reference's JSONL (``export_trace`` / ``import_trace``): a file either
package writes, the other reads.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional

import numpy as np

from repro_torch.core import costmodel
from repro_torch.hw import HardwareProfile, A6000_PCIE4


# ---------------------------------------------------------------------------
# workload traces (paper Table 2 tasks x Azure-like invocation patterns)
# ---------------------------------------------------------------------------

TASK_INPUT_LENS = {"mail": 867, "conv": 1154, "code": 2048, "longbench": 6101}


@dataclasses.dataclass(frozen=True)
class SimRequest:
    fn_name: str
    arrival_s: float
    input_len: int
    req_id: int = 0
    # per-request queueing budget (the live gateway's deadline_s): a
    # request still queued past it is SHED without consuming service
    deadline_s: Optional[float] = None
    # the live gateway's admission priority (higher admits first under
    # bounded admission); the sim's FIFO queues carry it through traces
    priority: int = 0


def make_trace(fn_rates: dict, duration_s: float, fn_tasks: dict,
               seed: int = 0, fn_deadlines: Optional[dict] = None,
               fn_priorities: Optional[dict] = None) -> list:
    """Poisson arrivals per function; rates in requests/s (the paper scales
    7-day Azure traces into a compressed window the same way).
    ``fn_deadlines`` / ``fn_priorities`` optionally stamp per-function
    queueing budgets and admission priorities onto the requests."""
    rng = np.random.default_rng(seed)
    reqs = []
    rid = 0
    for fn, rate in fn_rates.items():
        t = 0.0
        ilen = TASK_INPUT_LENS[fn_tasks[fn]]
        deadline = (fn_deadlines or {}).get(fn)
        priority = int((fn_priorities or {}).get(fn, 0))
        while True:
            t += rng.exponential(1.0 / rate)
            if t >= duration_s:
                break
            reqs.append(SimRequest(fn, t, ilen, rid, deadline_s=deadline,
                                   priority=priority))
            rid += 1
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs


def export_trace(requests: list, path: str) -> int:
    """Write a trace as JSONL, one SimRequest per line.

    Floats round-trip exactly (json uses repr-faithful shortest floats),
    so export -> import is BIT-IDENTICAL: the same file drives the
    simulator and the live gateway replay with equal arrival stamps.
    Returns the number of requests written."""
    with open(path, "w") as f:
        for r in requests:
            rec = {"fn_name": r.fn_name, "arrival_s": float(r.arrival_s),
                   "input_len": int(r.input_len), "req_id": int(r.req_id),
                   "deadline_s": (None if r.deadline_s is None
                                  else float(r.deadline_s)),
                   "priority": int(r.priority)}
            f.write(json.dumps(rec) + "\n")
    return len(requests)


def import_trace(path: str) -> list:
    """Read a JSONL trace back into SimRequests (inverse of export)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(SimRequest(**json.loads(line)))
    return out


# ---------------------------------------------------------------------------
# function profiles (latency oracles built on the cost model)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FunctionProfile:
    name: str
    plan_for_len: Callable[[int], costmodel.WorkloadPlan]
    dynamic_bytes: int = 0               # LoRA-style per-request weights
    template_bytes: int = 0              # device-resident prefix budget
    model_bytes: int = 0

    def __post_init__(self):
        self._plans: dict = {}

    def plan(self, input_len: int) -> costmodel.WorkloadPlan:
        if input_len not in self._plans:
            self._plans[input_len] = self.plan_for_len(input_len)
        return self._plans[input_len]


@dataclasses.dataclass
class RequestResult:
    req: SimRequest
    ttft_s: float                # includes queueing
    service_s: float
    queue_s: float
    kind: str                    # 'warm' | 'fork' | 'cold' | 'shed'
    rejected: bool = False
    hedged: bool = False
    shed: bool = False           # deadline expired while queued
    failed: bool = False         # every service attempt crashed
    retries: int = 0             # crash retries this request consumed


@dataclasses.dataclass
class SchedulerConfig:
    n_gpus: int = 8
    policy: str = "tidal"        # 'serverlessllm' | 'tidal' | 'tidal-dk'
    keep_alive_s: float = 10.0
    timeout_s: float = 60.0
    dk: bool = False             # keep-alive via adaptive fork for dynamic fns
    hw: HardwareProfile = A6000_PCIE4
    hbm_budget: float = 40e9     # usable HBM for instances+templates per GPU
    hedge_after: Optional[float] = None   # straggler mitigation threshold
    capacity_events: tuple = ()  # (time_s, +n/-n) elastic scaling events
    # locality: prefer the warm GPU unless waiting for it costs more than
    # this over the best idle GPU (bounds the queueing cost of affinity)
    locality_max_extra_wait_s: float = 2.0
    # measured mode: any object with .service_s(fn_name, kind, input_len)
    # -> Optional[float] (e.g. repro_torch.runtime.faas.MeasuredServiceTimes);
    # None falls through to the analytic oracle per lookup
    measured: Optional[object] = None
    # fault/availability accounting (mirrors the live gateway supervisor):
    # each service attempt independently crashes with probability
    # ``crash_rate`` (seeded draws — same seed, same fault schedule),
    # burning ``crash_service_frac`` of its service time on the GPU and
    # losing that GPU's warm instance before dying; the scheduler then
    # retries on the least-loaded online GPU after exponential backoff,
    # up to ``max_retries`` times, before declaring the request failed
    crash_rate: float = 0.0
    crash_seed: int = 0
    max_retries: int = 2
    retry_backoff_s: float = 0.25
    crash_service_frac: float = 0.5


class _GPU:
    def __init__(self, gid: int, hbm: float):
        self.gid = gid
        self.busy_until = 0.0
        self.hbm = hbm
        self.warm: dict = {}          # fn -> (expire_s, bytes)
        self.online = True

    def free_hbm(self, now: float) -> float:
        self._expire(now)
        return self.hbm - sum(b for _, b in self.warm.values())

    def _expire(self, now: float) -> None:
        for fn in [f for f, (exp, _) in self.warm.items() if exp <= now]:
            del self.warm[fn]

    def evict_lru(self, need: float, now: float) -> None:
        order = sorted(self.warm.items(), key=lambda kv: kv[1][0])
        for fn, (_, b) in order:
            if self.free_hbm(now) >= need:
                return
            del self.warm[fn]


class ClusterSim:
    def __init__(self, cfg: SchedulerConfig, functions: dict):
        self.cfg = cfg
        self.functions = functions
        self.gpus = [_GPU(i, cfg.hbm_budget) for i in range(cfg.n_gpus)]

    # ---- latency oracles -------------------------------------------------
    def _cold_ttft(self, prof: FunctionProfile, input_len: int) -> float:
        hw = self.cfg.hw
        plan = prof.plan(input_len)
        if self.cfg.policy == "serverlessllm":
            return costmodel.ttft_load_then_infer(
                plan, hw, cold_kernels=True, host_factor=1.02).total
        tb = prof.template_bytes if self.cfg.policy.startswith("tidal") else 0
        return costmodel.ttft_tidal(
            plan, hw, template_bytes=tb, dynamic_bytes=prof.dynamic_bytes,
            prewarmed=True).total

    def _warm_ttft(self, prof: FunctionProfile, input_len: int) -> float:
        plan = prof.plan(input_len)
        return costmodel.ttft_execution(plan, self.cfg.hw).total

    def _fork_ttft(self, prof: FunctionProfile, input_len: int) -> float:
        """Dynamic function on a warm instance via adaptive fork: static
        weights already resident; only the adapter replays."""
        hw = self.cfg.hw
        plan = prof.plan(input_len)
        return costmodel.ttft_tidal(
            plan, hw, template_bytes=plan.total_weight_bytes,
            dynamic_bytes=prof.dynamic_bytes, prewarmed=True).total

    def _service(self, kind: str, prof: FunctionProfile,
                 input_len: int) -> float:
        """Service time for one request: measured if available, analytic
        otherwise."""
        if self.cfg.measured is not None:
            t = self.cfg.measured.service_s(prof.name, kind, input_len)
            if t is not None:
                return float(t)
        if kind == "warm":
            return self._warm_ttft(prof, input_len)
        if kind == "fork":
            return self._fork_ttft(prof, input_len)
        return self._cold_ttft(prof, input_len)

    # ---- scheduling -------------------------------------------------------
    def _apply_capacity(self, now: float) -> None:
        for t, delta in self.cfg.capacity_events:
            if t <= now and delta != 0:
                if delta > 0:
                    for _ in range(delta):
                        self.gpus.append(_GPU(len(self.gpus),
                                              self.cfg.hbm_budget))
                else:
                    for g in self.gpus[::-1]:
                        if delta == 0:
                            break
                        if g.online:
                            g.online = False
                            delta += 1
        self.cfg = dataclasses.replace(
            self.cfg,
            capacity_events=tuple((t, d) for t, d in self.cfg.capacity_events
                                  if t > now))

    def _pick_gpu(self, fn: str, now: float):
        online = [g for g in self.gpus if g.online]
        best_any = min(online, key=lambda g: max(now, g.busy_until))
        warm = [g for g in online if fn in g.warm and g.warm[fn][0] > now]
        if warm:
            best_warm = min(warm, key=lambda g: max(now, g.busy_until))
            extra = (max(now, best_warm.busy_until)
                     - max(now, best_any.busy_until))
            if extra <= self.cfg.locality_max_extra_wait_s:
                return best_warm
        return best_any

    def run(self, requests: list) -> list:
        cfg = self.cfg
        out = []
        # drawn only when faults are enabled, so fault-free runs replay
        # bit-identically to configs that predate crash accounting
        crash_rng = (np.random.default_rng(cfg.crash_seed)
                     if cfg.crash_rate > 0 else None)
        for req in requests:
            self._apply_capacity(req.arrival_s)
            prof = self.functions[req.fn_name]
            gpu = self._pick_gpu(req.fn_name, req.arrival_s)
            start = max(req.arrival_s, gpu.busy_until)

            # straggler mitigation: hedge to another GPU if queueing long
            hedged = False
            if (cfg.hedge_after is not None
                    and start - req.arrival_s > cfg.hedge_after):
                others = [g for g in self.gpus if g.online and g is not gpu]
                if others:
                    alt = min(others, key=lambda g: g.busy_until)
                    alt_start = max(req.arrival_s, alt.busy_until)
                    if alt_start < start:
                        gpu, start, hedged = alt, alt_start, True

            queue = start - req.arrival_s
            if queue > cfg.timeout_s:                  # early-reject
                out.append(RequestResult(req, cfg.timeout_s, 0.0, queue,
                                         "cold", rejected=True, hedged=hedged))
                continue
            if req.deadline_s is not None and queue > req.deadline_s:
                # deadline shed: the request leaves the queue having
                # consumed NO service (mirrors the live gateway, which
                # sheds before prefill) — the queue behind it shortens
                out.append(RequestResult(req, req.deadline_s, 0.0, queue,
                                         "shed", shed=True, hedged=hedged))
                continue

            is_warm = (req.fn_name in gpu.warm
                       and gpu.warm[req.fn_name][0] > start)
            dynamic = prof.dynamic_bytes > 0
            if is_warm and (not dynamic):
                kind = "warm"
            elif is_warm and dynamic and cfg.dk:
                kind = "fork"
            else:
                need = prof.model_bytes
                if gpu.free_hbm(start) < need:
                    gpu.evict_lru(need, start)
                kind = "cold"
            service = self._service(kind, prof, req.input_len)

            # crash/retry accounting: an attempt that crashes burns part
            # of its service on the GPU and takes the warm instance with
            # it; the retry re-resolves placement and service class (the
            # crashed GPU lost its warmth, so retries often go cold)
            attempts = 0
            failed = False
            while (crash_rng is not None
                   and crash_rng.random() < cfg.crash_rate):
                wasted = cfg.crash_service_frac * service
                gpu.busy_until = start + wasted
                gpu.warm.pop(req.fn_name, None)
                if attempts >= cfg.max_retries:
                    failed = True
                    break
                attempts += 1
                retry_at = (start + wasted
                            + cfg.retry_backoff_s * (2 ** (attempts - 1)))
                online = [g for g in self.gpus if g.online]
                gpu = min(online, key=lambda g: max(retry_at, g.busy_until))
                start = max(retry_at, gpu.busy_until)
                queue = start - req.arrival_s
                is_warm = (req.fn_name in gpu.warm
                           and gpu.warm[req.fn_name][0] > start)
                if is_warm and (not dynamic):
                    kind = "warm"
                elif is_warm and dynamic and cfg.dk:
                    kind = "fork"
                else:
                    need = prof.model_bytes
                    if gpu.free_hbm(start) < need:
                        gpu.evict_lru(need, start)
                    kind = "cold"
                service = self._service(kind, prof, req.input_len)
            if failed:
                out.append(RequestResult(req, float("inf"), 0.0, queue,
                                         kind, hedged=hedged, failed=True,
                                         retries=attempts))
                continue

            end = start + service
            gpu.busy_until = end
            gpu.warm[req.fn_name] = (end + cfg.keep_alive_s, prof.model_bytes)
            out.append(RequestResult(req, queue + service, service, queue,
                                     kind, hedged=hedged, retries=attempts))
        return out


def percentile_ttft(results: list, q: float) -> float:
    vals = sorted(r.ttft_s for r in results)
    if not vals:
        return float("nan")
    return float(np.percentile(vals, q))


def summarize(results: list) -> dict:
    # failed requests never produced a first token (ttft inf): they count
    # as availability loss, not latency samples
    ttfts = [r.ttft_s for r in results if not r.failed]
    n = len(results)
    completed = sum(1 for r in results
                    if not (r.rejected or r.shed or r.failed))
    return {
        "n": n,
        "rejected": sum(r.rejected for r in results),
        "shed": sum(r.shed for r in results),
        "failed": sum(r.failed for r in results),
        "retried": sum(r.retries > 0 and not r.failed for r in results),
        "completed_frac": completed / n if n else None,
        "cold": sum(r.kind == "cold" and not r.rejected for r in results),
        "warm": sum(r.kind == "warm" for r in results),
        "fork": sum(r.kind == "fork" for r in results),
        "hedged": sum(r.hedged for r in results),
        "p50": float(np.percentile(ttfts, 50)) if ttfts else None,
        "p95": float(np.percentile(ttfts, 95)) if ttfts else None,
        "p99": float(np.percentile(ttfts, 99)) if ttfts else None,
        "mean": float(np.mean(ttfts)) if ttfts else None,
    }
