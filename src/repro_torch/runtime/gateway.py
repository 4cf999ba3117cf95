"""Async invocation gateway: ticketed lifecycle over the serving engines.

The port of ``repro.runtime.gateway``; its logic runs on the host and is
carried over whole, control-plane hooks and per-request adapter ids
included.  The background pump thread runs the engines (and the control
plane's ticks and bakes) on the runtime's card and its default stream.

The synchronous front door (``FaaSRuntime.submit_many``) drains one engine
to completion at a time, so a long decode on one function inflates
time-to-first-token for every request queued behind it.  This module is
the asynchronous redesign: ``submit(InvocationRequest)`` returns an
:class:`InvocationHandle` ticket immediately, and the gateway's
cooperative scheduling loop steps engines in bounded QUANTA, interleaving
across functions/instances so a short warm request admitted behind a
long-running function still gets a fast first token.

Request lifecycle::

    queued ──> admitted ──> streaming ──> done
       │            │            │
       │ deadline   └── cancel ──┴──> cancelled
       ├──────────> shed   (typed DeadlineExceeded, no prefill spent)
       └─ crash ──> queued (retry, ≤ max_retries) ──> failed (typed
                    EngineFailure once the retry budget is spent)

Scheduling is PARTITION-LEASE aware.  Engines on a shared PAGED arena
each hold a slot-partition lease (``PagedKVCachePool.register_owner``)
and decode under an owner-masked page table, so co-resident engines of
one base model interleave at quantum granularity — the old
exclusive-arena rule is gone for them.  Only DENSE-pool engines still
serialize at request granularity (a dense batched decode advances every
slot's recurrent state; no masked view protects a co-tenant).  At a
quantum boundary an engine yields *control* — releasing nothing: its
slots, pages and queue ride through.

The gateway is also the SUPERVISOR.  A typed crash escaping a quantum
(:class:`~repro_torch.runtime.errors.InjectedFault` from the fault plane, or
an :class:`~repro_torch.runtime.errors.EngineFailure`) retires the dead
engine's partition lease cleanly — every partition page returns to the
arena, COW prefix refcounts and co-tenant partitions are checked intact
and logged in ``failures`` — and its in-flight tickets are re-queued for
bounded retry with capped exponential backoff on a fresh or co-resident
engine.  Greedy determinism (and seeded sampling) makes retried requests
bit-identical; ``PrefixIndex`` reuse makes their re-prefill cheap.
Under sustained pressure the gateway degrades gracefully instead of
collapsing: ``max_live`` bounds admitted work (typed
:class:`~repro_torch.runtime.errors.Overloaded` rejection, lowest-priority
shed), and a brown-out mode shrinks per-request ``max_new_tokens`` and
the scheduling quantum while pressure stays above the threshold.

By default everything is cooperative and single-threaded: ``tokens()`` /
``result()`` pump the gateway while they wait, so no thread ever races
the card.  ``start_pump()`` moves the scheduling loop onto one
daemon thread — invocations then progress between consumer polls, and
``tokens()`` / ``result()`` become passive waiters on a condition
variable (the pump thread stays the ONLY thread stepping the engines).  A crash
escaping the pump loop itself is fatal-but-loud: every open handle fails
typed and the thread stops, so no passive waiter ever hangs on a dead
pump.  Greedy results are bit-identical to the drain-to-completion path
— the per-slot position vectors make each request's decode independent
of batch composition — which is what lets ``submit``/``submit_many``
stay thin compat shims over this gateway.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional

import numpy as np

import torch

from repro_torch.core.template_server import ForkStats
from repro_torch.runtime.errors import (
    DeadlineExceeded,
    EngineFailure,
    InjectedFault,
    InvocationCancelled,
    Overloaded,
    PoolExhausted,
    RuntimeFailure,
)

# lifecycle states
QUEUED = "queued"
ADMITTED = "admitted"
STREAMING = "streaming"
DONE = "done"
CANCELLED = "cancelled"
SHED = "shed"
FAILED = "failed"
TERMINAL = (DONE, CANCELLED, SHED, FAILED)


@dataclasses.dataclass
class InvocationRequest:
    """One asynchronous invocation of a deployed function."""

    fn_name: str
    prompt: Any                          # int32 token ids, any array-like
    event: Optional[dict] = None
    max_new_tokens: int = 8
    temperature: float = 0.0             # 0 = greedy (bit-parity reference)
    top_p: float = 1.0
    seed: int = 0
    deadline_s: Optional[float] = None   # queueing budget; expired => shed
    priority: int = 0                    # higher admits first
    # open-loop replay: backdate the arrival to this perf_counter stamp so
    # TTFT/deadlines count from the INTENDED arrival, not the submit call
    arrival_s: Optional[float] = None
    # per-request crash-retry budget; None defers to the gateway default
    max_retries: Optional[int] = None


@dataclasses.dataclass
class SubmitResult:
    """Terminal record of one invocation (also the compat-shim return)."""

    req_id: int
    fn_name: str
    kind: str                        # 'warm' | 'fork' | 'cold'
    tokens: np.ndarray               # [n_generated] int32
    ttft_s: float
    e2e_s: float
    streamed_prefill: bool = False
    fork_stats: Optional[ForkStats] = None
    reused_prefix_len: int = 0
    status: str = DONE               # 'done' | 'cancelled' | 'failed'
    retries: int = 0                 # crash retries this ticket survived


class InvocationHandle:
    """Ticket for one in-flight invocation.

    ``tokens()`` streams tokens as the engine emits them, ``result()``
    blocks (cooperatively pumping the gateway) until the terminal state,
    and ``cancel()`` retires the request wherever it is.  The handle never
    spins: waiting drives the gateway's scheduling loop.

    A handle whose engine crashed mid-flight detaches (``engine`` becomes
    None) while it waits in the gateway's retry queue; resubmission
    re-emits its token stream from index 0 — bit-identical under greedy
    decoding and seeded sampling — so consumers never observe the crash
    except as latency.
    """

    def __init__(self, gateway: "InvocationGateway",
                 request: InvocationRequest, req_id: int, engine_key: tuple,
                 engine, kind: str, fork_stats: Optional[ForkStats]):
        self._gateway = gateway
        self.request = request
        self.req_id = req_id
        self.engine_key = engine_key
        self.engine = engine
        self.kind = kind
        self.fork_stats = fork_stats
        self.submit_s = time.perf_counter()
        self.retries = 0                 # crash retries consumed so far
        self.browned_out = False         # max_new clamped at admission
        self._state = QUEUED
        self._tokens: list = []
        self._output = None              # engine RequestOutput at terminal
        self._result: Optional[SubmitResult] = None
        self._error: Optional[Exception] = None
        self._ttft_observed = False

    # -- lifecycle ------------------------------------------------------
    @property
    def status(self) -> str:
        """Current lifecycle state (one of the module's state constants)."""
        return self._state

    @property
    def done(self) -> bool:
        """True once the invocation reached a terminal state."""
        return self._state in TERMINAL

    def cancel(self) -> bool:
        """Retire the invocation now.

        A queued request is dropped before any prefill; an in-flight one
        releases its slot and KV pages (refcount-safely, including
        borrowed prefix pages); one awaiting crash-retry is dropped from
        the retry queue.  Returns False when the request already reached
        a terminal state.
        """
        return self._gateway.cancel(self)

    # -- consumption ----------------------------------------------------
    def tokens(self):
        """Stream tokens as the engine emits them (a per-token iterator).

        Yields each token as soon as it is sampled, pumping the gateway
        whenever no token is buffered yet.  Ends at completion or
        cancellation (the tokens emitted so far are all yielded); raises
        :class:`DeadlineExceeded` if the request was shed.
        """
        i = 0
        while True:
            while i < len(self._tokens):
                yield self._tokens[i]
                i += 1
            if self.done:
                if i < len(self._tokens):
                    continue             # terminal flush appended more
                self._raise_if_dead(allow_cancelled=True)
                return
            # pump only until the NEXT token lands (or the request
            # terminates) — not until completion: that is what makes this
            # a streaming iterator rather than a batch drain
            self._gateway.pump(wait_for=self,
                               until=lambda: len(self._tokens) > i)

    def result(self, timeout: Optional[float] = None) -> SubmitResult:
        """Pump the gateway until this invocation terminates.

        Returns its :class:`SubmitResult` (status ``'cancelled'`` keeps
        the tokens streamed before the cancel).  Raises
        :class:`DeadlineExceeded` for shed requests,
        :class:`PoolExhausted` for unservable ones,
        :class:`EngineFailure` when every crash retry was spent,
        :class:`Overloaded` for pressure-shed ones and
        :class:`TimeoutError` when ``timeout`` elapses first.
        """
        if not self._gateway.pump(wait_for=self, timeout=timeout):
            raise TimeoutError(
                f"invocation {self.req_id} ({self.request.fn_name}) still "
                f"{self._state!r} after {timeout}s")
        self._raise_if_dead(allow_cancelled=True)
        return self._result

    def _raise_if_dead(self, allow_cancelled: bool = False) -> None:
        if self._state == SHED:
            raise DeadlineExceeded(
                f"invocation {self.req_id} ({self.request.fn_name}): "
                f"deadline of {self.request.deadline_s}s expired while "
                "queued; request was shed before prefill")
        if self._state == FAILED:
            if self._error is not None:
                raise self._error
            raise PoolExhausted(
                (self._output.error if self._output is not None else None)
                or f"invocation {self.req_id} unservable")
        if self._state == CANCELLED and not allow_cancelled:
            raise InvocationCancelled(
                f"invocation {self.req_id} ({self.request.fn_name}) was "
                "cancelled")

    # -- gateway-side ---------------------------------------------------
    def _on_token(self, req_id: int, token: int, index: int) -> None:
        if index == 0:
            self._state = STREAMING
            if not self._ttft_observed:
                self._ttft_observed = True
                # Eq. 1 TTFT feedback fires on token 0, not at batch
                # drain: residency adapts while the request is decoding
                self._gateway.runtime.observe_ttft(
                    self.request.fn_name,
                    time.perf_counter() - self.submit_s)
        if index < len(self._tokens):
            # crash-retry re-emission: the fresh engine replays the stream
            # from index 0; determinism makes the overwrite a no-op
            self._tokens[index] = int(token)
        else:
            self._tokens.append(int(token))

    def _finalize(self, out) -> None:
        self._output = out
        self._tokens = list(int(t) for t in out.tokens)
        self._state = {"done": DONE, "cancelled": CANCELLED,
                       "shed": SHED, "failed": FAILED}[out.status]
        if self._state == FAILED and self._error is None:
            self._error = PoolExhausted(
                out.error or f"invocation {self.req_id} unservable")
        self._result = SubmitResult(
            req_id=self.req_id, fn_name=self.request.fn_name, kind=self.kind,
            tokens=np.asarray(out.tokens, np.int32), ttft_s=out.ttft_s,
            e2e_s=out.e2e_s, streamed_prefill=out.streamed_prefill,
            fork_stats=self.fork_stats,
            reused_prefix_len=out.reused_prefix_len,
            status=out.status if out.status != "failed" else CANCELLED,
            retries=self.retries)
        self._gateway._note_terminal(self)

    def _fail(self, error: Exception) -> None:
        """Terminalize as FAILED with a typed error (crash/overload path)."""
        self._error = error
        self._state = FAILED
        self._result = SubmitResult(
            req_id=self.req_id, fn_name=self.request.fn_name, kind=self.kind,
            tokens=np.asarray(self._tokens, np.int32),
            ttft_s=float("nan"), e2e_s=float("nan"),
            fork_stats=self.fork_stats, status=FAILED, retries=self.retries)
        self._gateway._note_terminal(self)


class InvocationGateway:
    """Cooperative scheduling loop multiplexing engines under one runtime.

    ``quantum`` bounds how many decode steps an engine runs before control
    returns to the rotation (1 = finest interleaving, higher amortizes
    dispatch overhead).  ``quantum_tokens`` switches the quantum to
    bounded TOKEN work instead of a step count — the right unit under
    chunked prefill, where one step may spend a whole chunk of prompt
    tokens on top of its decode batch — so a rotation hands every engine
    a comparable slice of compute regardless of how its steps split
    between prefill chunks and decode.  ``interleave=False`` degrades to
    the legacy drain-to-completion order — the baseline the p95 benchmark
    gates against.

    Supervision knobs: ``max_retries`` crash retries per ticket with
    ``retry_backoff_s``-seeded capped exponential backoff
    (``max_backoff_s``).  Degradation knobs: ``max_live`` bounds in-flight
    invocations (arrivals beyond it shed the lowest-priority queued
    ticket they outrank, or raise typed ``Overloaded``);
    ``brownout_threshold`` is the in-flight fraction of ``max_live`` at
    which brown-out engages, clamping new arrivals' ``max_new_tokens`` to
    ``brownout_max_new`` and halving the scheduling quantum so admitted
    work drains sooner.  ``failures`` logs one dict per recovered engine
    crash (teardown invariants included); ``stats`` counts supervision
    events.
    """

    def __init__(self, runtime, quantum: int = 2, interleave: bool = True,
                 quantum_tokens: Optional[int] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.0,
                 max_backoff_s: float = 1.0,
                 max_live: Optional[int] = None,
                 brownout_threshold: float = 0.75,
                 brownout_max_new: Optional[int] = None):
        self.runtime = runtime
        self.quantum = quantum
        self.quantum_tokens = quantum_tokens
        self.interleave = interleave
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.max_live = max_live
        self.brownout_threshold = float(brownout_threshold)
        self.brownout_max_new = brownout_max_new
        self._live: list[InvocationHandle] = []
        self._rr = 0                     # round-robin offset over engines
        self._retry: list[tuple[float, InvocationHandle]] = []
        self.failures: list[dict] = []   # one entry per recovered crash
        self.stats = {"engine_failures": 0, "retries": 0, "gave_up": 0,
                      "overload_rejections": 0, "pressure_sheds": 0,
                      "brownout_clamps": 0}
        # background pump: one daemon thread owns ALL engine stepping while
        # it runs; consumers wait on the condition instead of pumping
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_stop = False
        self._pump_error: Optional[BaseException] = None

    # -- intake ---------------------------------------------------------
    def submit(self, request: InvocationRequest) -> InvocationHandle:
        """Validate, resolve the serving engine and enqueue the request.

        A missing warm engine forks one (the fork's weight stream
        overlaps later scheduling).  Returns the ticket immediately; no
        decode work happens until the gateway is pumped.  With
        ``max_live`` set, admission is bounded: an arrival into a full
        gateway sheds the lowest-priority queued ticket it outranks or
        raises typed :class:`Overloaded`, and while pressure is above the
        brown-out threshold the request's token budget is clamped.
        """
        now = (time.perf_counter() if request.arrival_s is None
               else request.arrival_s)
        rt = self.runtime
        with self._wake:
            rt._prune(now)
            prompt = np.asarray(request.prompt, np.int32).reshape(-1)
            rt._validate(request.fn_name, prompt, request.max_new_tokens)
            if rt.control_plane is not None:
                # every VALID arrival trains the forecaster — including
                # ones shed below: the arrival pattern is real even when
                # the service never happens
                rt.control_plane.on_arrival(request.fn_name, now,
                                            request.event)
            if (request.deadline_s is not None
                    and time.perf_counter() - now > request.deadline_s):
                # dead on arrival against the request's OWN clock: a
                # replayed request whose backdated ``arrival_s`` already
                # overran its deadline (the replay fell behind wall-clock)
                # is shed here, before forking an engine or spending any
                # prefill — the shed decision honors the intended arrival,
                # not the submit call
                handle = InvocationHandle(self, request, -1, None, None,
                                          "shed", None)
                handle.submit_s = now
                handle._state = SHED
                self._note_terminal(handle)
                return handle
            request, browned_out = self._admit_bounded(request)
            key, engine, kind, stats = rt._engine_for(request.fn_name,
                                                      request.event, now)
            rt._count(request.fn_name, kind)
            handle = InvocationHandle(self, request, -1, key, engine, kind,
                                      stats)
            handle.submit_s = now        # TTFT includes the fork above
            handle.browned_out = browned_out
            handle.req_id = engine.submit(
                prompt, request.max_new_tokens, submit_s=now,
                temperature=request.temperature, top_p=request.top_p,
                seed=request.seed, deadline_s=request.deadline_s,
                priority=request.priority, token_cb=handle._on_token,
                adapter_id=rt._adapter_id_for(request.fn_name, key))
            self._live.append(handle)
            self._wake.notify_all()      # background pump: new work landed
            return handle

    def _admit_bounded(self, request: InvocationRequest):
        """Apply bounded admission + brown-out to an arriving request.

        Args:
            request: the arriving invocation.

        Returns:
            ``(request, browned_out)`` — the request, with its
            ``max_new_tokens`` clamped when brown-out is active.

        Raises:
            Overloaded: the gateway is full and the arrival outranks no
                queued ticket.
        """
        if self.max_live is None:
            return request, False
        live = sum(1 for h in self._live if not h.done)
        if live >= self.max_live:
            victim = self._shed_victim(request.priority)
            if victim is None:
                self.stats["overload_rejections"] += 1
                self.runtime._count(request.fn_name, "rejected")
                raise Overloaded(
                    f"gateway at max_live={self.max_live} in-flight "
                    f"invocations; priority {request.priority} arrival "
                    "outranks no queued work")
            self._shed_for_pressure(victim)
            live -= 1
        browned_out = False
        if (self.brownout_max_new is not None
                and live + 1 >= self.brownout_threshold * self.max_live
                and request.max_new_tokens > self.brownout_max_new):
            # brown-out: shrink the decode budget of NEW work so admitted
            # tickets drain before deadlines blow, instead of letting
            # every request keep its full budget and all of them miss
            self.stats["brownout_clamps"] += 1
            request = dataclasses.replace(
                request, max_new_tokens=self.brownout_max_new)
            browned_out = True
        return request, browned_out

    def _shed_victim(self, priority: int) -> Optional[InvocationHandle]:
        """Pick the queued ticket an arrival of ``priority`` may displace.

        Only strictly lower-priority, still-QUEUED tickets qualify (no
        prefill spent, so shedding wastes nothing); among them the
        lowest-priority, youngest one is returned.  None when the arrival
        outranks nothing.
        """
        cands = [h for h in self._live
                 if not h.done and h._state == QUEUED
                 and h.request.priority < priority]
        if not cands:
            return None
        return min(cands, key=lambda h: (h.request.priority, -h.submit_s))

    def _shed_for_pressure(self, victim: InvocationHandle) -> None:
        """Retire ``victim`` with typed ``Overloaded`` to admit better work."""
        if victim.engine is None:        # was awaiting crash-retry
            self._retry = [(t, h) for (t, h) in self._retry
                           if h is not victim]
        else:
            victim.engine.cancel(victim.req_id)
            victim.engine.results.pop(victim.req_id, None)
        victim._fail(Overloaded(
            f"invocation {victim.req_id} ({victim.request.fn_name}) shed "
            "while queued: gateway full and a higher-priority request "
            "arrived"))
        self.stats["pressure_sheds"] += 1

    def pressure(self) -> float:
        """In-flight invocations as a fraction of ``max_live`` (0 if unbounded)."""
        if self.max_live is None:
            return 0.0
        return (sum(1 for h in self._live if not h.done)
                / float(self.max_live))

    def brownout_active(self) -> bool:
        """True while in-flight pressure is at/above the brown-out threshold."""
        return (self.max_live is not None
                and self.pressure() >= self.brownout_threshold)

    def _note_terminal(self, handle: InvocationHandle) -> None:
        """Fold one terminal ticket into the observation stream.

        Bumps the runtime's per-function service-class counters and —
        when a control plane is attached — feeds completed invocations
        (prompt, kind, reuse length) to its prefix observer.  Every
        terminalization path routes through here exactly once.
        """
        rt = self.runtime
        fn_name = handle.request.fn_name
        state = handle._state
        if state == DONE:
            rt._count(fn_name, "done")
            res = handle._result
            reused = res.reused_prefix_len if res is not None else 0
            if reused > 0:
                rt._count(fn_name, "reuse_hits")
            if rt.control_plane is not None:
                rt.control_plane.on_completion(
                    fn_name, handle.request.event,
                    np.asarray(handle.request.prompt,
                               np.int32).reshape(-1),
                    handle.kind, reused, time.perf_counter())
        elif state == SHED:
            rt._count(fn_name, "shed")
        elif state == CANCELLED:
            rt._count(fn_name, "cancelled")
        elif state == FAILED:
            rt._count(fn_name, "failed")

    def cancel(self, handle: InvocationHandle) -> bool:
        """Cancel the handle's request; False if already terminal."""
        with self._wake:
            if handle.done:
                return False
            if handle.engine is None:
                # awaiting crash-retry: nothing engine-side to undo
                self._retry = [(t, h) for (t, h) in self._retry
                               if h is not handle]
                handle._state = CANCELLED
                handle._result = SubmitResult(
                    req_id=handle.req_id, fn_name=handle.request.fn_name,
                    kind=handle.kind,
                    tokens=np.asarray(handle._tokens, np.int32),
                    ttft_s=float("nan"), e2e_s=float("nan"),
                    fork_stats=handle.fork_stats, status=CANCELLED,
                    retries=handle.retries)
                self._note_terminal(handle)
                return True
            if handle.engine.cancel(handle.req_id):
                self._collect(handle.engine)
                return True
            return False

    # -- scheduling -----------------------------------------------------
    def pump(self, wait_for: Optional[InvocationHandle] = None,
             timeout: Optional[float] = None, until=None) -> bool:
        """Run scheduling rounds until ``wait_for`` reaches a terminal state.

        With ``wait_for=None``, pumps until every live invocation drains.
        ``until`` is an extra early-exit predicate — the streaming
        iterator passes "one more token buffered".  Returns False only
        when ``timeout`` elapsed first.
        """
        t_end = None if timeout is None else time.perf_counter() + timeout
        t = self._pump_thread
        if t is not None and t.is_alive():
            got = self._pump_wait(wait_for, until, t_end)
            if got is not None:
                return got
            # the pump thread died mid-wait: fall back to cooperative
            # pumping so no waiter ever hangs on a dead pump
        while True:
            if wait_for is not None and wait_for.done:
                return True
            if until is not None and until():
                return True
            self._live = [h for h in self._live if not h.done]
            if not self._live:
                return wait_for is None or wait_for.done
            if t_end is not None and time.perf_counter() >= t_end:
                return wait_for is None or wait_for.done
            with self._lock:
                self._round()

    def _pump_wait(self, wait_for, until, t_end) -> Optional[bool]:
        """Wait passively on the background pump; None => pump died.

        Args:
            wait_for: handle whose terminal state ends the wait.
            until: extra early-exit predicate.
            t_end: absolute ``perf_counter`` deadline, or None.

        Returns:
            The value ``pump`` should return, or None when the pump
            thread died and the caller must pump cooperatively instead.
        """
        with self._wake:
            while True:
                if wait_for is not None and wait_for.done:
                    return True
                if self._pump_error is not None:
                    err, self._pump_error = self._pump_error, None
                    raise err
                if until is not None and until():
                    return True
                if not any(not h.done for h in self._live):
                    return wait_for is None or wait_for.done
                t = self._pump_thread
                if t is None or not t.is_alive():
                    return None
                if t_end is None:
                    self._wake.wait(0.05)
                else:
                    left = t_end - time.perf_counter()
                    if left <= 0:
                        return wait_for is None or wait_for.done
                    self._wake.wait(min(left, 0.05))

    # -- background pump ------------------------------------------------
    def start_pump(self) -> None:
        """Move the scheduling loop onto a daemon thread.

        While the pump runs, ``tokens()`` / ``result()`` wait passively —
        invocations progress between consumer polls — and the pump thread
        is the ONLY thread stepping the engines (submit/cancel serialize against
        it on the gateway lock).  Idempotent."""
        with self._lock:
            if self._pump_thread is not None and self._pump_thread.is_alive():
                return
            self._pump_stop = False
            self._pump_error = None
            self._pump_thread = threading.Thread(
                target=self._pump_loop, name="gateway-pump", daemon=True)
            self._pump_thread.start()

    def stop_pump(self) -> None:
        """Stop the pump thread (joining it); cooperative pumping resumes."""
        t = self._pump_thread
        if t is None:
            return
        with self._wake:
            self._pump_stop = True
            self._wake.notify_all()
        t.join()
        self._pump_thread = None

    def _pump_loop(self) -> None:
        """Background scheduling loop (body of the pump daemon thread).

        Typed engine crashes are absorbed inside ``_round`` by the
        supervisor; an exception escaping it is a scheduler-level fault,
        which is fatal-but-loud: every open ticket fails typed (so no
        passive ``tokens()``/``result()`` waiter hangs), the raw error is
        surfaced to the next handle-less ``pump()`` caller, and the
        thread stops cleanly.  ``start_pump`` may then be called again.
        """
        try:
            # CUDA work issued from this thread runs on the runtime's
            # card, on its default stream, like the caller's would
            if self.runtime.device.type == "cuda":
                torch.cuda.set_device(self.runtime.device)
            while True:
                with self._wake:
                    if self._pump_stop:
                        return
                    self._live = [h for h in self._live if not h.done]
                    if not self._live:
                        self._wake.wait(0.02)
                        continue
                    self._round()
                    self._wake.notify_all()
        except BaseException as e:
            with self._wake:
                for h in self._live:
                    if not h.done:
                        failure = EngineFailure(
                            f"invocation {h.req_id} "
                            f"({h.request.fn_name}): gateway pump thread "
                            f"crashed: {e!r}")
                        failure.__cause__ = e
                        h._fail(failure)
                self._retry.clear()
                self._pump_error = e
                self._pump_stop = True
                self._wake.notify_all()

    def drain(self) -> None:
        """Pump until no live invocation remains."""
        self.pump()

    def replay(self, schedule) -> list:
        """Open-loop replay of a ``[(offset_s, request)]`` schedule.

        Each request is ticketed once its offset (from replay start)
        elapses — pumping in-flight work while waiting, never blocking
        arrivals on it — with the arrival backdated to the INTENDED
        offset, so TTFT and deadlines measure open-loop lateness even
        when the engines fall behind.  Overload rejections become SHED
        handles so the caller still gets one handle per scheduled
        request.  Returns the handles in schedule order after a full
        drain.
        """
        t0 = time.perf_counter()
        handles, i = [], 0
        schedule = sorted(schedule, key=lambda s: s[0])
        while i < len(schedule):
            due, request = schedule[i]
            wait = due - (time.perf_counter() - t0)
            if wait > 0:
                if any(not h.done for h in handles):
                    self.pump(timeout=wait)
                elif self.runtime.control_plane is not None:
                    # idle gap between arrivals: sleep in tick-sized
                    # slices so the control plane can prewarm/bake AHEAD
                    # of the next burst instead of reacting to it
                    cp = self.runtime.control_plane
                    with self._lock:
                        cp.maybe_tick()
                    time.sleep(min(wait, max(cp.tick_interval_s, 1e-3)))
                else:
                    time.sleep(wait)
                continue
            try:
                handles.append(self.submit(
                    dataclasses.replace(request, arrival_s=t0 + due)))
            except Overloaded as e:
                h = InvocationHandle(self, request, -1, None, None,
                                     "shed", None)
                h.submit_s = t0 + due
                h._fail(e)
                handles.append(h)
            i += 1
        self.drain()
        return handles

    def _engines(self) -> list:
        seen, out = set(), []
        for h in self._live:
            if h.done or h.engine is None:
                continue                 # terminal, or awaiting retry
            if id(h.engine) not in seen:
                seen.add(id(h.engine))
                out.append(h.engine)
        return out

    def _pool_owner(self, pool, engines: list):
        """Find the engine holding active slots in a DENSE ``pool``.

        Dense-pool engines still borrow the arena exclusively (a dense
        batched decode advances every slot's recurrent state), so only
        the returned engine may decode there.  PAGED pools have no single
        owner — every co-resident engine holds a slot-partition lease and
        decodes under its own masked page table — so this returns None
        and the rotation interleaves them freely.
        """
        if hasattr(pool, "register_owner"):
            return None                  # paged arena: partition leases
        cands = {id(e): e for e in engines}
        for w in self.runtime._engines.values():
            cands.setdefault(id(w.engine), w.engine)
        for e in cands.values():
            if e.pool is pool and e.active:
                return e
        return None

    def _round(self) -> None:
        """Run one rotation: every eligible engine gets one quantum.

        Due crash-retries are resubmitted first.  A typed crash escaping
        an engine's quantum (injected fault or ``EngineFailure``) is
        absorbed here: the supervisor retires the engine and re-queues
        its tickets (see ``_recover_engine``) while the rotation carries
        on with the surviving engines.  In drain mode the first runnable
        engine runs to completion instead.
        """
        cp = self.runtime.control_plane
        if cp is not None:
            # actuate the control plane from the scheduling loop: ticks
            # stay cooperative, so whichever thread pumps (caller or the
            # background pump daemon) remains the only engine stepper
            cp.maybe_tick()
        next_due = self._service_retries()
        engines = self._engines()
        if not engines:
            if next_due is not None:
                # nothing runnable until a backoff expires: yield briefly
                # instead of hot-spinning the scheduling loop
                time.sleep(min(next_due, 0.005))
            return
        for engine in engines:       # finalize results already produced
            self._collect(engine)
        pending = [e for e in engines if e.n_pending]
        if not pending:
            return
        if self.interleave:
            k = self._rr % len(pending)
            self._rr += 1
            order = pending[k:] + pending[:k]
        else:
            order = pending
        quantum, quantum_tokens = self.quantum, self.quantum_tokens
        if self.brownout_active():
            # brown-out shrinks the quantum too: finer interleaving means
            # short clamped requests overtake long in-flight ones sooner
            quantum = max(1, quantum // 2)
            if quantum_tokens is not None:
                quantum_tokens = max(1, quantum_tokens // 2)
        stepped = False
        for engine in order:
            owner = self._pool_owner(engine.pool, engines)
            if owner is not None and owner is not engine:
                continue
            try:
                if not self.interleave:
                    engine.run()
                elif quantum_tokens is not None:
                    engine.step_tokens(quantum_tokens)
                else:
                    engine.step_n(quantum)
            except PoolExhausted:
                # the engine dropped the one doomed request and recorded
                # its 'failed' result — THAT handle raises the typed
                # error from result(); every other ticket keeps serving
                pass
            except (InjectedFault, EngineFailure) as e:
                self._recover_engine(engine, e)
                stepped = True
                continue
            finally:
                self._collect(engine)
            stepped = True
            if not self.interleave:
                return               # drain discipline: one engine fully
        if not stepped and next_due is None:
            # every pending engine was blocked behind a foreign-owned
            # arena whose owner is outside the gateway: never spin
            # silently
            raise RuntimeError(
                "gateway livelock: no engine could take a quantum "
                f"({len(pending)} still pending)")

    # -- supervision ----------------------------------------------------
    def _service_retries(self) -> Optional[float]:
        """Resubmit crash-retry tickets whose backoff expired.

        Returns:
            Seconds until the earliest still-pending retry is due, or
            None when the retry queue is empty afterwards.
        """
        if not self._retry:
            return None
        now = time.perf_counter()
        due = [h for (t, h) in self._retry if t <= now]
        self._retry = [(t, h) for (t, h) in self._retry if t > now]
        for h in due:
            if not h.done:               # cancelled while waiting: skip
                self._resubmit(h)
        if not self._retry:
            return None
        return max(0.0, min(t for (t, _) in self._retry) - now)

    def _recover_engine(self, engine, error: BaseException) -> None:
        """Supervise one engine crash: clean teardown, then bounded retry.

        Teardown ordering matters and is verified as it happens:

        1. harvest results the engine finished before the crash (their
           handles are NOT victims) — without cancelling orphans: a
           request the crash caught mid-admission is in neither the
           engine's queue nor its active set, and must stay live to be
           re-queued as a victim below;
        2. snapshot co-tenant partition stats and the arena's free-page
           count;
        3. retire the engine's partition lease (``close()`` cancels its
           in-flight work, returns every partition page — refcounted COW
           prefix pages included — and releases the owner token);
        4. verify co-tenant partitions are bit-identical to the snapshot
           and log the free-page delta next to the victim partition's
           page count (the ``failures`` entry benchmarks gate on);
        5. detach each victim ticket and schedule it for retry with
           capped exponential backoff, or fail it typed when its budget
           is spent.

        Args:
            engine: the engine whose quantum raised.
            error: the typed crash (becomes ``__cause__`` of terminal
                ``EngineFailure``).
        """
        rt = self.runtime
        self._collect(engine, cancel_orphans=False)
        victims = [h for h in self._live if h.engine is engine and not h.done]
        pool = engine.pool
        paged = hasattr(pool, "partition_stats")
        owner = getattr(engine, "_owner", None)
        entry = {"engine_key": None, "error": repr(error),
                 "n_victims": len(victims), "cotenants_intact": True}
        cotenants = {}
        if paged:
            cotenants = {o: pool.partition_stats(o)
                         for o in list(pool._owners) if o != owner}
            victim_stats = (pool.partition_stats(owner)
                            if owner in pool._owners else None)
            entry["victim_mapped_pages"] = (
                victim_stats["mapped_pages"] if victim_stats else 0)
            entry["victim_reserved_pages"] = (
                victim_stats["reserved_pages"] if victim_stats else 0)
            entry["free_pages_before"] = pool.n_free_pages
            entry["available_pages_before"] = pool.n_available_pages
        keys = [k for k, w in rt._engines.items() if w.engine is engine]
        entry["engine_key"] = keys[0] if keys else None
        for k in keys:
            rt._drop_engine(k)           # close(): cancel + lease teardown
        if not keys:
            engine.close()               # already evicted from the runtime
        if paged:
            entry["free_pages_after"] = pool.n_free_pages
            entry["available_pages_after"] = pool.n_available_pages
            after = {o: pool.partition_stats(o)
                     for o in cotenants if o in pool._owners}
            entry["cotenants_intact"] = (after == cotenants)
        self.stats["engine_failures"] += 1
        self.failures.append(entry)
        now = time.perf_counter()
        for h in victims:
            h.engine = None
            h.engine_key = None
            budget = (h.request.max_retries
                      if h.request.max_retries is not None
                      else self.max_retries)
            if h.retries < budget:
                h.retries += 1
                delay = min(self.retry_backoff_s * (2 ** (h.retries - 1)),
                            self.max_backoff_s)
                self._retry.append((now + delay, h))
                self.stats["retries"] += 1
            else:
                failure = EngineFailure(
                    f"invocation {h.req_id} ({h.request.fn_name}): engine "
                    f"{entry['engine_key']} crashed and the retry budget "
                    f"({budget}) is exhausted")
                failure.__cause__ = error
                h._fail(failure)
                self.stats["gave_up"] += 1

    def _resubmit(self, h: InvocationHandle) -> None:
        """Re-ticket a crash victim on a fresh or co-resident engine.

        The original ``submit_s`` is preserved so TTFT (and the request's
        deadline) keeps counting across the crash, and the token callback
        re-emits from index 0 — bit-identical under greedy decoding, so
        a consumer that already streamed a prefix observes no seam.

        Args:
            h: detached victim handle (``engine`` is None).
        """
        req = h.request
        rt = self.runtime
        now = time.perf_counter()
        try:
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            key, engine, kind, stats = rt._engine_for(req.fn_name,
                                                      req.event, now)
            h.engine_key, h.engine, h.kind = key, engine, kind
            if stats is not None:
                h.fork_stats = stats
            h._state = QUEUED
            h.req_id = engine.submit(
                prompt, req.max_new_tokens, submit_s=h.submit_s,
                temperature=req.temperature, top_p=req.top_p,
                seed=req.seed, deadline_s=req.deadline_s,
                priority=req.priority, token_cb=h._on_token,
                adapter_id=rt._adapter_id_for(req.fn_name, key))
        except RuntimeFailure as e:
            h.engine = None
            h._fail(e)
            self.stats["gave_up"] += 1
        except Exception as e:           # resolution itself blew up
            failure = EngineFailure(
                f"invocation retry for {req.fn_name} could not be "
                f"resubmitted: {e!r}")
            failure.__cause__ = e
            h.engine = None
            h._fail(failure)
            self.stats["gave_up"] += 1

    def _collect(self, engine, cancel_orphans: bool = True) -> None:
        now = time.perf_counter()
        for h in self._live:
            if h.engine is not engine or h.done or engine is None:
                continue
            out = engine.results.pop(h.req_id, None)
            if out is not None:
                h._finalize(out)
            elif any(st.req.req_id == h.req_id
                     for st in engine.active.values()):
                if h._state == QUEUED:
                    h._state = ADMITTED
            elif cancel_orphans and h.req_id not in {r.req_id
                                                     for r in engine.queue}:
                # the engine no longer knows this request and produced no
                # result (it was evicted out from under us): terminate the
                # ticket instead of letting its consumer pump forever
                h._tokens = list(h._tokens)
                h._state = CANCELLED
                h._result = SubmitResult(
                    req_id=h.req_id, fn_name=h.request.fn_name, kind=h.kind,
                    tokens=np.asarray(h._tokens, np.int32),
                    ttft_s=float("nan"), e2e_s=float("nan"),
                    fork_stats=h.fork_stats, status=CANCELLED,
                    retries=h.retries)
                self._note_terminal(h)
            w = self.runtime._engines.get(h.engine_key)
            if w is not None and w.engine is engine:
                w.last_used_s = now
