"""Continuous-batching serving engine over the KV-cache pools.

The port of ``repro.runtime.continuous.ContinuousBatchingEngine``.  The
engine keeps an admission queue and a step loop:

  * **prefill-on-arrival** — a queued request is admitted the moment a slot
    (and, paged, its pages) fit: its prompt prefills as a batch-1 call
    (suffix-only over the shared pages of a prefix hit; layer-streamed
    when ``params`` is a :class:`ForkSession` whose weights are still in
    flight) and the filled cache lands in the pool;
  * **batched decode** — every step issues ONE decode over the whole slot
    axis with a per-slot position vector: ``decode_step_paged`` under the
    engine's owner-masked page table over a ``PagedKVCachePool``, or
    ``decode_step`` over a dense ``KVCachePool`` (``paged=False``, the
    ``decode_attention`` kernel), so requests of different lengths and
    ages share the batch;
  * **retirement** — finished requests release their slot (and pages).

With ``chunk_tokens`` (paged pools only), prefill is chunked into the step
loop: each step advances mid-prefill slots by up to ``chunk_tokens``
prompt tokens (page-multiple ``prefill_from`` calls), then runs one
batched decode over the slots past their prompt.  Mid-prefill slots ride
the decode batch as dummies writing at the last padded position, whose
block stays unmapped while the cursor is short of the prompt, so the
write lands on the null page and the logits row is discarded, exactly
like a free slot's.

Greedy decoding reproduces the JAX engine's tokens request by request
(tested): the port runs the same admission, page and position logic.
``step_n`` and ``step_tokens`` are the gateway's scheduling quanta.

``adapter_bank`` (paged pools only) makes one engine serve MANY
functions: each request carries an ``adapter_id`` and every prefill and
decode gathers its slot's LoRA delta from the bank (id 0 = the null
adapter, carried by free and foreign slots).

``plan`` (a ``distributed.sharding.ShardingPlan``, the model's) serves a
tensor-parallel model: the engine runs on the controller rank only, and
every call it makes into the model, the pool and the fork session is a
device op that the workers run on their shards (``distributed.group``);
token batches, page tables and adapter ids cross to them as host arrays.
An adapter bank under a plan is the rank's shard on every rank
(``models.adapters``); ``set_adapter``'s row writes are a device op, its
``adapter_load`` fault point fires on the controller before the op is
sent.  On another instance's ranks than the controller's, the engine
drives the controller's shadows of that instance's objects and reads
each model call's logits from the instance's first rank
(``distributed.group``).  Enc-dec models raise ``NotImplementedError``,
as in the JAX package: they serve through the sequential ``Engine``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.streaming import (ForkSession, streamed_prefill,
                                        supports_streamed_prefill)
from repro_torch.models.adapters import bank_n_adapters, load_adapter
from repro_torch.models.registry import Model
from repro_torch.runtime.engine import sample_greedy, sample_token
from repro_torch.runtime.faults import fault_point
from repro_torch.runtime.kv_pool import (KVCachePool, PagedKVCachePool,
                                         PoolExhausted)

_UNMATCHED = object()                # prefix match not yet attempted


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int
    submit_s: float
    temperature: float = 0.0         # 0 = greedy (bit-parity reference)
    top_p: float = 1.0
    seed: int = 0                    # per-request sampling seed
    deadline_s: Optional[float] = None  # shed if still QUEUED past this
    priority: int = 0                # higher admits first (FIFO within)
    token_cb: Optional[Callable] = None  # (req_id, token, index) per emit
    adapter_id: int = 0              # bank row (0 = null adapter / base)
    # prefix-reuse match, resolved lazily at first admission check and
    # cached ((handle, reuse_len) or None); _UNMATCHED = not yet looked up
    prefix_hit: Any = _UNMATCHED


@dataclasses.dataclass
class RequestOutput:
    req_id: int
    tokens: np.ndarray               # [n_generated] int32
    prompt_len: int
    n_generated: int
    ttft_s: float                    # submit -> first token (incl. queueing)
    e2e_s: float                     # submit -> retirement
    streamed_prefill: bool = False   # admitted while weights were in flight
    reused_prefix_len: int = 0       # prompt tokens served from shared pages
    status: str = "done"             # 'done' | 'cancelled' | 'shed' | 'failed'
    error: Optional[str] = None      # set for 'failed' (unservable) requests


@dataclasses.dataclass
class _Active:
    req: Request
    slot: int
    tokens: list
    ttft_s: float
    streamed: bool = False
    reused_prefix_len: int = 0
    cursor: int = 0                  # prompt tokens prefilled so far
    prefilling: bool = False         # True until the cursor reaches the prompt


class ContinuousBatchingEngine:
    """Multi-request generation for one model instance.

    ``params`` is the model's parameter dict (a warm instance) or a
    :class:`ForkSession` (a freshly forked one): with a session,
    admissions before the stream completes prefill layer by layer against
    the weights already on the device, and the first batched decode waits
    only for the remaining copies.  ``pool`` injects a shared pool
    (engines of one model co-reside on a paged arena under owner leases);
    otherwise the engine builds its own on the model's device: paged for
    the attention families unless ``paged=False``.

    The engine calls the model's own ``prefill`` / ``prefill_from`` /
    ``decode_step(_paged)``: eager PyTorch has no compiled executables to
    inject, so the JAX engine's ``prefill_fn`` / ``decode_fn`` parameters
    have no counterpart here.  ``n_decode_steps`` and ``n_prefill_calls``
    count the batched decode steps and the prefill calls this engine has
    run.
    """

    def __init__(self, model: Model, params: Any, n_slots: int = 4,
                 max_len: int = 128,
                 paged: Optional[bool] = None, page_size: int = 8,
                 n_pages: Optional[int] = None,
                 plan: Optional[Any] = None, pool: Optional[Any] = None,
                 prefix_index: Optional[Any] = None,
                 bucket_suffix: bool = False,
                 chunk_tokens: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 adapter_bank: Optional[dict] = None,
                 owner_name: Optional[str] = None):
        if model.is_encdec:
            raise NotImplementedError(
                "continuous batching needs per-slot decode positions; the "
                "enc-dec family still serves through the sequential Engine")
        if plan is not None and plan.tp > 1 and plan != model.plan:
            raise ValueError("the engine's plan must be its model's: build "
                             "the model under the plan (get_model(..., "
                             "plan=plan))")
        if not isinstance(params, (dict, ForkSession)):
            raise TypeError("params must be a parameter dict or a "
                            f"ForkSession, not {type(params).__name__}")
        self.model = model
        self.session = params if isinstance(params, ForkSession) else None
        self._params = None if self.session is not None else params
        if pool is not None:
            self.pool = pool
            self.paged = isinstance(pool, PagedKVCachePool)
            n_slots = pool.n_slots
        else:
            self.paged = model.supports_paged_kv if paged is None else paged
            if self.paged:
                self.pool = PagedKVCachePool(model, n_slots, max_len,
                                             page_size=page_size,
                                             n_pages=n_pages,
                                             kv_dtype=kv_dtype)
            else:
                if kv_dtype is not None:
                    raise ValueError(
                        "kv_dtype quantization needs the paged arena")
                self.pool = KVCachePool(model, n_slots, max_len)
        self.device = self.pool.device
        if adapter_bank is not None and not self.paged:
            raise ValueError("adapter banks serve over the paged arena only")
        self.adapter_bank = adapter_bank
        # partition lease: a paged engine's slots file under its owner
        # token and its decode steps run under the pool's masked table.
        # Dense pools have no mask and are borrowed exclusively.
        self._owner = (self.pool.register_owner(owner_name)
                       if self.paged else None)
        self.owner_name = owner_name
        self.queue: collections.deque = collections.deque()
        self.active: dict = {}                       # slot -> _Active
        self.results: dict = {}                      # req_id -> RequestOutput
        self._next_id = 0
        self.prefix_index = prefix_index
        # round suffix-prefill lengths up to a page multiple (by shrinking
        # the reuse), as the JAX engine does for its compiled buckets
        self.bucket_suffix = bucket_suffix
        # chunked prefill needs a position-addressable (paged) cache
        self.chunk_tokens = None
        if chunk_tokens is not None and self.paged:
            ps = self.pool.page_size
            self.chunk_tokens = max(ps, ps * -(-int(chunk_tokens) // ps))
        # per-slot feedback state (free slots decode position 0 / token 0;
        # their logits are computed and discarded)
        self._tok = np.zeros((n_slots, 1), np.int32)
        self._pos = np.zeros((n_slots,), np.int32)
        # per-slot adapter ids (0 = null adapter: free and foreign slots
        # and base-model requests gather a zero delta)
        self._aid = np.zeros((n_slots,), np.int32)
        self._step_tokens = 0            # work done by the last step()
        self.n_decode_steps = 0
        self.n_prefill_calls = 0

    def params(self):
        """Full params (a session waits for its outstanding copies)."""
        if self._params is None:
            self._params = self.session.params()
        return self._params

    # ------------------------------------------------------------------
    @property
    def n_pending(self) -> int:
        return len(self.queue) + len(self.active)

    def set_adapter(self, idx: int, adapter, alpha: float = 1.0) -> None:
        """Load a LoRA checkpoint into bank row ``idx``, in place: steps
        already issued run before the write on the engine's stream.  Under
        a plan every rank writes its shard of the row (a device op sent
        after the fault point)."""
        if self.adapter_bank is None:
            raise ValueError("engine was built without an adapter bank")
        fault_point("adapter_load", f"row={idx}")
        load_adapter(self.adapter_bank, idx, adapter, self.model, alpha=alpha)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 8,
               submit_s: Optional[float] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: int = 0, deadline_s: Optional[float] = None,
               priority: int = 0,
               token_cb: Optional[Callable] = None,
               adapter_id: int = 0) -> int:
        """Enqueue one request (see ``repro.runtime.continuous`` for the
        meaning of every argument).  ``temperature=0`` decodes greedily;
        ``deadline_s`` sheds a request still queued past it; ``priority``
        ranks admission; ``token_cb(req_id, token, index)`` streams;
        ``adapter_id`` selects the request's bank row (0 = the base)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if adapter_id:
            if self.adapter_bank is None:
                raise ValueError(
                    "adapter_id set but the engine has no adapter bank")
            if not (0 <= adapter_id < bank_n_adapters(self.adapter_bank)):
                raise ValueError(f"adapter_id {adapter_id} out of range")
        if temperature < 0 or not (0 < top_p <= 1):
            raise ValueError("need temperature >= 0 and 0 < top_p <= 1")
        if len(prompt) + max_new_tokens > self.pool.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new_tokens}) exceeds "
                f"pool max_len={self.pool.max_len}")
        if self.paged:
            need = self.pool.blocks_for(len(prompt) + max_new_tokens)
            if need > self.pool.n_pages - 1:
                raise ValueError(
                    f"request needs {need} KV pages but the arena has only "
                    f"{self.pool.n_pages - 1} allocatable pages")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, prompt, max_new_tokens,
                                  submit_s or time.perf_counter(),
                                  temperature=temperature, top_p=top_p,
                                  seed=seed, deadline_s=deadline_s,
                                  priority=priority, token_cb=token_cb,
                                  adapter_id=adapter_id))
        return rid

    def cancel(self, req_id: int) -> bool:
        """Cancel one request wherever it is; False when already finished."""
        for req in self.queue:
            if req.req_id == req_id:
                self.queue.remove(req)
                self._record_dropped(req, "cancelled")
                return True
        for slot, st in list(self.active.items()):
            if st.req.req_id == req_id:
                self._retire(slot, status="cancelled")
                return True
        return False

    # ------------------------------------------------------------------
    def _prefix_hit(self, req: Request):
        """Resolve (and cache) the request's longest usable cached prefix;
        a handle released after matching falls back to full prefill."""
        if req.prefix_hit is _UNMATCHED:
            req.prefix_hit = None
            if self.paged and self.prefix_index is not None:
                req.prefix_hit = self.prefix_index.match(req.prompt)
            if req.prefix_hit is not None and (
                    self.bucket_suffix or self.chunk_tokens is not None):
                # shrink the reuse so the suffix length is a page multiple
                handle, reuse = req.prefix_hit
                pad = (reuse - len(req.prompt)) % self.pool.page_size
                if pad:
                    reuse -= pad
                    req.prefix_hit = (handle, reuse) if reuse >= 1 else None
        if req.prefix_hit is not None and not req.prefix_hit[0].pinned:
            req.prefix_hit = None            # stale handle: full prefill
        return req.prefix_hit

    def _chunked(self, req: Request, reuse: int) -> bool:
        return (self.chunk_tokens is not None
                and len(req.prompt) - reuse > self.chunk_tokens)

    def _can_admit(self, req: Request) -> bool:
        if not self.paged:
            return bool(self.pool.n_free)
        hit = self._prefix_hit(req)
        reuse = hit[1] if hit else 0
        total = len(req.prompt) + req.max_new_tokens
        if self._chunked(req, reuse):
            # chunked admission reserves only the FIRST chunk's pages
            total = reuse + self.chunk_tokens
        return self.pool.can_admit(total, reuse_len=reuse)

    def _record_dropped(self, req: Request, status: str,
                        error: Optional[str] = None) -> None:
        """Result for a request that never reached (or left) a slot."""
        elapsed = time.perf_counter() - req.submit_s
        self.results[req.req_id] = RequestOutput(
            req_id=req.req_id, tokens=np.zeros(0, np.int32),
            prompt_len=len(req.prompt), n_generated=0,
            ttft_s=elapsed, e2e_s=elapsed, status=status, error=error)

    def _shed_expired(self, now: float) -> None:
        """Deadline-expired QUEUED requests are shed (never in-flight ones)."""
        for req in [r for r in self.queue if r.deadline_s is not None
                    and now - r.submit_s > r.deadline_s]:
            self.queue.remove(req)
            self._record_dropped(req, "shed")

    def _queue_head(self) -> Request:
        """Admission order: highest priority first, FIFO within a rank."""
        return max(self.queue, key=lambda r: (r.priority, -r.req_id))

    def _next_admission(self) -> Optional[Request]:
        """The queue head if it fits now; it blocks lower ranks otherwise."""
        if not self.queue:
            return None
        head = self._queue_head()
        return head if self._can_admit(head) else None

    def _tokens(self, toks: np.ndarray):
        """A host batch on the device; under a plan the host array itself,
        which every rank's model call uploads to its own device."""
        toks = np.ascontiguousarray(toks)
        if self.model.plan is not None:
            return toks
        return torch.as_tensor(toks, device=self.device)

    def _streams(self) -> bool:
        """True while prefill must consume weights still in flight (never
        for a bank engine: its prefill gathers adapter rows)."""
        return (self.session is not None and self._params is None
                and self.adapter_bank is None
                and supports_streamed_prefill(self.model))

    def _prefill(self, toks: np.ndarray, cache: dict, offset: int,
                 adapter_id: int = 0):
        """Whole-prompt (offset 0) or suffix-only prefill, batch 1;
        layer-streamed while a fork's weights are in flight; under the
        request's adapter row in a bank engine.  Returns (logits, cache,
        streamed)."""
        self.n_prefill_calls += 1
        toks = self._tokens(toks)
        if self._streams():
            logits, cache = streamed_prefill(self.session, {"tokens": toks},
                                             cache, offset=offset)
            return logits, cache, True
        bank = {}
        if self.adapter_bank is not None:
            bank = {"adapter_bank": self.adapter_bank,
                    "adapter_ids": [adapter_id]}
        if offset:
            logits, cache = self.model.prefill_from(
                self.params(), {"tokens": toks}, cache, offset, **bank)
        else:
            logits, cache = self.model.prefill(self.params(),
                                               {"tokens": toks}, cache, **bank)
        return logits, cache, False

    def _sample_first(self, req: Request, logits: torch.Tensor) -> int:
        if req.temperature <= 0:
            return int(sample_greedy(logits)[0])
        return sample_token(logits[0].float().cpu().numpy(), req.temperature,
                            req.top_p, req.seed, 0)

    def _admit(self, req: Request) -> None:
        # injection point BEFORE any allocation
        fault_point("prefill_chunk",
                    f"admit:req={req.req_id}:len={len(req.prompt)}")
        hit = self._prefix_hit(req) if self.paged else None
        reuse = hit[1] if hit else 0
        if self.paged and self._chunked(req, reuse):
            # reserve only the first chunk's pages and park the slot
            # mid-prefill: it rides the decode batch as a null-page dummy
            # (token 0 at the last padded position) until its final chunk
            slot = self.pool.alloc(len(req.prompt), req.max_new_tokens,
                                   shared_prefix=hit[0] if hit else None,
                                   reuse_len=reuse,
                                   budget_tokens=reuse + self.chunk_tokens,
                                   owner=self._owner)
            self._tok[slot, 0] = 0
            self._pos[slot] = self.pool.padded_len - 1
            self._aid[slot] = req.adapter_id
            self.active[slot] = _Active(req=req, slot=slot, tokens=[],
                                        ttft_s=0.0, reused_prefix_len=reuse,
                                        cursor=reuse, prefilling=True)
            return
        if self.paged:
            slot = self.pool.alloc(len(req.prompt), req.max_new_tokens,
                                   shared_prefix=hit[0] if hit else None,
                                   reuse_len=reuse, owner=self._owner)
        else:
            slot = self.pool.alloc()
        try:
            self._prefill_into(req, slot, reuse)
        except BaseException:
            # hand the slot (and its pages) straight back before re-raising
            self._release(slot)
            raise

    def _release(self, slot: int) -> None:
        if self.paged:
            self.pool.release(slot, owner=self._owner)
        else:
            self.pool.release(slot)

    def _prefill_into(self, req: Request, slot: int, reuse: int) -> None:
        """Whole-prompt (or suffix-only) prefill into an allocated slot."""
        if reuse:
            # gather the slot's pages (aliased prefix + its COW partial
            # copy) as the working dense cache; prefill only the suffix
            cache = self.pool.read_slot_full(slot)
        else:
            cache = self.model.make_cache(
                1, self.pool.padded_len if self.paged else self.pool.max_len)
        logits, cache, streamed = self._prefill(req.prompt[None, reuse:],
                                                cache, reuse, req.adapter_id)
        first = self._sample_first(req, logits)
        ttft = time.perf_counter() - req.submit_s
        if self.paged:
            self.pool.write_suffix(slot, cache, reuse, len(req.prompt),
                                   owner=self._owner)
            self._aid[slot] = req.adapter_id
        else:
            self.pool.write_slot(slot, cache)
        self._tok[slot, 0] = first
        # next decode writes the first generated token at position len(prompt)
        self._pos[slot] = len(req.prompt)
        st = _Active(req=req, slot=slot, tokens=[first], ttft_s=ttft,
                     streamed=streamed, reused_prefix_len=reuse)
        self.active[slot] = st
        if req.token_cb is not None:
            req.token_cb(req.req_id, first, 0)
        if len(st.tokens) >= req.max_new_tokens:
            self._retire(slot)

    def _run_chunk(self, slot: int) -> int:
        """Advance one mid-prefill slot by up to ``chunk_tokens`` prompt
        tokens.  Returns the tokens processed — 0 when the pool cannot
        extend the slot's page budget yet (retried next step)."""
        st = self.active[slot]
        req = st.req
        fault_point("prefill_chunk",
                    f"chunk:req={req.req_id}:cursor={st.cursor}")
        P = len(req.prompt)
        ps = self.pool.page_size
        rem = P - st.cursor
        final = rem <= self.chunk_tokens
        if final:
            # the full worst-case budget is reserved before the first
            # generated token exists, so decode's ensure_len cannot fail
            if not self.pool.extend_budget(slot, P + req.max_new_tokens,
                                           owner=self._owner):
                return 0
            # re-run back to the last page boundary so the chunk length
            # stays a page multiple; re-prefilled tokens rewrite their own
            # pages with identical values
            start = max(st.reused_prefix_len, P - ps * -(-rem // ps))
            end = P
        else:
            start = st.cursor
            end = st.cursor + self.chunk_tokens
            if not self.pool.extend_budget(slot, end, owner=self._owner):
                return 0
        cache = self.pool.read_slot_full(slot)
        logits, cache, streamed = self._prefill(req.prompt[None, start:end],
                                                cache, start, req.adapter_id)
        self.pool.write_suffix(slot, cache, start, end, owner=self._owner)
        st.streamed = st.streamed or streamed
        st.cursor = end
        if final:
            first = self._sample_first(req, logits)
            st.ttft_s = time.perf_counter() - req.submit_s
            st.prefilling = False
            st.tokens.append(first)
            self._tok[slot, 0] = first
            self._pos[slot] = P
            if req.token_cb is not None:
                req.token_cb(req.req_id, first, 0)
            if len(st.tokens) >= req.max_new_tokens:
                self._retire(slot)
        return end - start

    def _retire(self, slot: int, status: str = "done",
                error: Optional[str] = None) -> None:
        st = self.active.pop(slot)
        self._release(slot)
        self._tok[slot, 0] = 0
        self._pos[slot] = 0
        self._aid[slot] = 0
        e2e = time.perf_counter() - st.req.submit_s
        self.results[st.req.req_id] = RequestOutput(
            req_id=st.req.req_id,
            tokens=np.asarray(st.tokens, np.int32),
            prompt_len=len(st.req.prompt),
            n_generated=len(st.tokens),
            # a slot cancelled/failed mid-prefill never emitted a token
            ttft_s=st.ttft_s if st.tokens else e2e,
            e2e_s=e2e,
            streamed_prefill=st.streamed,
            reused_prefix_len=st.reused_prefix_len,
            status=status, error=error)

    # ------------------------------------------------------------------
    def _foreign_slots(self) -> int:
        """Slots of the pool allocated by a DIFFERENT engine."""
        if self.paged:
            return self.pool.n_foreign_slots(self._owner)
        return (self.pool.n_slots - self.pool.n_free) - len(self.active)

    def step(self) -> bool:
        """One MIXED batched step: admit what fits, advance mid-prefill
        cursors by up to ``chunk_tokens`` prompt tokens, run one batched
        decode over the slots past their prompt, retire the finished.

        Returns False once the engine is fully drained."""
        if self.queue or self.active:
            fault_point("engine_step",
                        f"{self.owner_name or 'engine'}:"
                        f"pending={self.n_pending}")
        if (self.queue or self.active) and not self.paged:
            # a dense batched decode writes EVERY slot's row (no masked
            # view protects a co-tenant), so dense pools are exclusive
            foreign = self._foreign_slots()
            if foreign > 0:
                raise RuntimeError(
                    f"shared KV pool: {foreign} slot(s) held by another "
                    "engine; drain or evict it before decoding here "
                    "(dense-pool engines borrow the arena exclusively)")
        self._shed_expired(time.perf_counter())
        self._step_tokens = 0
        admitted = 0
        while True:
            head = self._next_admission()
            if head is None:
                break
            self.queue.remove(head)
            self._admit(head)
            admitted += 1
        chunked = 0
        if self.chunk_tokens is not None:
            # spend up to chunk_tokens prompt tokens across the
            # mid-prefill slots, oldest request first
            budget = self.chunk_tokens
            for slot in sorted(
                    (s for s in self.active if self.active[s].prefilling),
                    key=lambda s: self.active[s].req.req_id):
                if budget <= 0:
                    break
                n = self._run_chunk(slot)
                budget -= n
                chunked += n
        decoding = [s for s in self.active if not self.active[s].prefilling]
        if decoding:
            fault_point("decode_quantum",
                        f"{self.owner_name or 'engine'}:n={len(decoding)}")
        if not decoding:
            if not self.active:
                if self.queue:
                    if self.paged and self._foreign_slots() > 0:
                        # co-tenants may still free pages: back-pressure
                        self._step_tokens = chunked
                        return True
                    # an idle arena that still cannot fit the head can
                    # never free pages for it: drop it and raise
                    head = self._queue_head()
                    self.queue.remove(head)
                    msg = (
                        f"request {head.req_id} needs more KV pages than "
                        "the idle arena can ever free (pinned prefix pages "
                        "shrink attainable capacity); use a larger arena "
                        "or release template prefixes")
                    self._record_dropped(head, "failed", error=msg)
                    raise PoolExhausted(msg)
                return False
            if not admitted and not chunked:
                if self.paged and self._foreign_slots() > 0:
                    return True
                # every slot is mid-prefill and none could grow its budget:
                # fail the YOUNGEST mid-prefill request to unwedge the rest
                slot = max((s for s in self.active
                            if self.active[s].prefilling),
                           key=lambda s: self.active[s].req.req_id)
                msg = (
                    f"request {self.active[slot].req.req_id} cannot grow "
                    "its chunked-prefill page budget and no decode can "
                    "free pages (all slots mid-prefill); failed to unwedge "
                    "the arena — use a larger arena or smaller chunks")
                self._retire(slot, status="failed", error=msg)
                raise PoolExhausted(msg)
            self._step_tokens = chunked
            return True
        toks, pos = self._tokens(self._tok), self._tokens(self._pos)
        if self.paged:
            # crossing a page boundary maps one more (already reserved)
            # page; mid-prefill slots skip this — their dummy page stays
            # unmapped.  The OWNER-masked view nulls co-tenants' rows, so
            # their slots decode as free-slot dummies
            for slot in decoding:
                self.pool.ensure_len(slot, int(self._pos[slot]) + 1,
                                     owner=self._owner)
            pt = (self.pool.host_page_table(self._owner)
                  if self.model.plan is not None
                  else self.pool.device_page_table(self._owner))
            bank = {}
            if self.adapter_bank is not None:
                bank = {"adapter_bank": self.adapter_bank,
                        "adapter_ids": self._tokens(self._aid)}
            logits, _ = self.model.decode_step_paged(
                self.params(), self.pool.cache, {"tokens": toks}, pos, pt,
                self.pool.page_size, **bank)
        else:
            logits, _ = self.model.decode_step(
                self.params(), self.pool.cache, {"tokens": toks}, pos)
        self.n_decode_steps += 1
        nxt = sample_greedy(logits).cpu().numpy()        # [n_slots]
        sampled = [s for s in decoding if self.active[s].req.temperature > 0]
        if sampled:
            rows = logits.float().cpu().numpy()
            for slot in sampled:
                st = self.active[slot]
                nxt[slot] = sample_token(rows[slot], st.req.temperature,
                                         st.req.top_p, st.req.seed,
                                         len(st.tokens))
        for slot in decoding:
            st = self.active[slot]
            tok = int(nxt[slot])
            st.tokens.append(tok)
            self._tok[slot, 0] = tok
            self._pos[slot] += 1
            if st.req.token_cb is not None:
                st.req.token_cb(st.req.req_id, tok, len(st.tokens) - 1)
            if len(st.tokens) >= st.req.max_new_tokens:
                self._retire(slot)
        self._step_tokens = chunked + len(decoding)
        return bool(self.queue or self.active)

    def step_n(self, n: int) -> bool:
        """Up to ``n`` steps: the gateway's scheduling quantum.  Between
        calls the engine yields control holding everything it has (slots,
        pages, queue).  Returns False once fully drained."""
        for _ in range(max(1, n)):
            if not self.step():
                return False
        return True

    def step_tokens(self, budget: int) -> bool:
        """Steps until at least ``budget`` tokens of work have run: the
        gateway's TOKEN quantum under chunked prefill, where a step's cost
        is its chunked prompt tokens plus its decode batch.  Returns False
        once fully drained."""
        spent = 0
        while spent < max(1, budget):
            alive = self.step()
            spent += max(1, self._step_tokens)
            if not alive:
                return False
        return True

    def run(self) -> dict:
        """Drain queue + active set; returns {req_id: RequestOutput}."""
        while self.step():
            pass
        return self.results

    def release_all(self) -> int:
        """Abandon in-flight work: release every active slot and drop
        queued requests (each records a ``'cancelled'`` result).  Returns
        the number of abandoned requests."""
        n = len(self.active) + len(self.queue)
        for slot in list(self.active):
            self._retire(slot, status="cancelled")
        for req in list(self.queue):
            self._record_dropped(req, "cancelled")
        self.queue.clear()
        return n

    def close(self) -> int:
        """Release all in-flight work, then retire the engine's partition
        lease.  A closed engine must not step again."""
        n = self.release_all()
        if self.paged and self._owner is not None:
            self.pool.release_owner(self._owner)
            self._owner = None
        return n
