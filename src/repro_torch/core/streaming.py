"""Overlapped weight streaming and layer-granular execution (TIDAL §5.2,
Figure 12 right).

``WeightStreamer`` is the template server's loader: a background thread
copies each weight from the host pool to the device in the traced access
order.  On a card the host pool is pinned memory and every copy is a
``copy_(non_blocking=True)`` issued on the streamer's own CUDA stream,
followed by one recorded ``torch.cuda.Event`` per weight.  A consumer
waits on the host event ("copy issued"), then makes its compute stream
wait on the CUDA event: that is TIDAL's injected synchronization event
between an async copy and the kernels that read it, and the compute
stream waits on the device, not on the host.  Every streamed tensor the
compute stream uses is marked with ``record_stream``, so the caching
allocator never hands its memory out while a kernel may still read it.
On the CPU the copies are plain clones in the same order, which
validates the schedule and the synchronisation logic.

``streamed_prefill`` runs the first prefill layer by layer while later
layers' weights are still in flight: layer ``l``'s block waits only for
layer ``l``'s weights.  Its result equals the monolithic prefill exactly
(it runs the same ``transformer._dense_block``, for zamba the same
``transformer.zamba_unit`` and for xlstm the same
``transformer.xlstm_unit``; tested with ``torch.equal``).  The dense,
moe, zamba and xlstm families stream.  A moe layer's three expert leaves
are most of its bytes, and the layer waits for them alone, not for later
layers.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.group import current_group, mirrored
from repro_torch.models import transformer
from repro_torch.models.layers import embed_tokens, lm_head, rmsnorm
from repro_torch.models.registry import Model
from repro_torch.utils import map_with_path

_fault_point = None


def _visit_fault_point(point: str, detail: str,
                       instance: Optional[int] = None) -> None:
    # lazy import: runtime.continuous imports this module, so repro_torch.
    # core must import before repro_torch.runtime finishes initializing
    global _fault_point
    if _fault_point is None:
        from repro_torch.runtime.faults import fault_point
        _fault_point = fault_point
    _fault_point(point, detail, instance)


@dataclasses.dataclass
class StreamEntry:
    key: tuple                            # (path, ())
    fetch: Callable[[], torch.Tensor]     # host-pool tensor provider


class WeightStreamer:
    """Background device uploader following the traced access order."""

    def __init__(self, entries: list, resident: dict, dynamic: dict,
                 device="cpu", record_order: bool = True,
                 fetch_retries: int = 2, retry_backoff_s: float = 0.005,
                 max_backoff_s: float = 0.25):
        """resident/dynamic: {path: device tensor} available immediately.

        A fetch that raises is retried up to ``fetch_retries`` times with
        capped exponential backoff (``retry_backoff_s`` doubling up to
        ``max_backoff_s``) before the failure propagates.  Weights that
        landed before a terminal failure stay servable; a failure sets
        every pending event, so no consumer hangs."""
        self.entries = entries
        self.resident = dict(resident)
        self.dynamic = dict(dynamic)
        self.device = torch.device(device)
        self.fetch_retries = int(fetch_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.retries_used = 0
        # the serving instance of the op that made this streamer: its
        # fetch thread visits ``weight_fetch`` on that instance's copy of
        # the fault plan (runtime.faults), as that instance's ranks do
        group = current_group()
        self._instance = None if group is None else group.op_instance()
        self._arrays: dict = {}
        self._events: dict = {e.key: threading.Event() for e in entries}
        self._copied: dict = {}           # key -> torch.cuda.Event (card only)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.completed_order: Optional[list] = [] if record_order else None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def start(self) -> "WeightStreamer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="weight-streamer")
        self._thread.start()
        return self

    def _upload(self, src: torch.Tensor):
        """Issue one host->device copy; returns (tensor, CUDA event)."""
        if self._stream is None:
            return src.to(self.device, copy=True), None
        with torch.cuda.stream(self._stream):
            dst = torch.empty_like(src, device=self.device)
            dst.copy_(src, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._stream)
        return dst, copied

    def _fetch_one(self, e: StreamEntry):
        """Fetch and upload one weight, retrying transient failures."""
        delay = self.retry_backoff_s
        attempt = 0
        while True:
            try:
                _visit_fault_point("weight_fetch", f"{e.key[0]}:{e.key[1]}",
                                   self._instance)
                return self._upload(e.fetch())
            except Exception:
                attempt += 1
                if attempt > self.fetch_retries:
                    raise
                self.retries_used += 1
                time.sleep(delay)
                delay = min(delay * 2.0, self.max_backoff_s)

    def _run(self):
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
            for e in self.entries:
                self._arrays[e.key], self._copied[e.key] = self._fetch_one(e)
                if self.completed_order is not None:
                    self.completed_order.append(e.key)
                self._events[e.key].set()
        except BaseException as ex:  # surfaced on the next get()
            self._error = ex
            for ev in self._events.values():
                ev.set()

    # ---- consumer side -----------------------------------------------------
    def _consume(self, key: tuple) -> torch.Tensor:
        """The streamed tensor, ordered after its copy on the caller's
        current stream (device-side wait, no host synchronisation)."""
        t = self._arrays[key]
        copied = self._copied.get(key)
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            t.record_stream(stream)
        return t

    def get(self, key: tuple) -> torch.Tensor:
        path = key[0]
        for store in (self.resident, self.dynamic):
            if path in store:
                return store[path]
        ev = self._events.get(key)
        if ev is None:
            raise KeyError(f"{key} neither resident, dynamic nor streamed")
        ev.wait()
        # a fetch failure sets every event so no consumer hangs: weights
        # that landed before the failure stay servable, the rest raise
        if key in self._arrays:
            return self._consume(key)
        raise self._error

    def wait_all(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error


class ForkSession:
    """The materialized state of one forked invocation."""

    def __init__(self, model: Model, streamer: WeightStreamer):
        self.model = model
        self.streamer = streamer
        self._specs = model.param_specs()
        self._params = None

    def leaf(self, path: str) -> torch.Tensor:
        return self.streamer.get((path, ()))

    def layer_params(self, layer: int, group: str = "layers") -> dict:
        """One layer's parameter dict of a per-layer ``group`` (``layers``,
        zamba's ``mamba``, xlstm's ``mlstm`` and ``slstm``), waiting only
        on that layer."""
        return map_with_path(lambda p, _: self.leaf(p),
                             self._specs[group][layer], f"{group}.{layer}.")

    def block_params(self, name: str) -> dict:
        """The parameter dict of one named block (zamba's ``shared_attn``),
        waiting only on its weights."""
        return map_with_path(lambda p, _: self.leaf(p), self._specs[name],
                             f"{name}.")

    @mirrored(register=("return",))
    def params(self) -> dict:
        """The full parameter dict (waits for every outstanding copy)."""
        if self._params is None:
            self._params = map_with_path(lambda p, _: self.leaf(p),
                                         self._specs)
        return self._params


# ---------------------------------------------------------------------------
# layer-streamed prefill
# ---------------------------------------------------------------------------

def supports_streamed_prefill(model: Model) -> bool:
    return model.cfg.family in ("dense", "moe", "zamba", "xlstm")


@mirrored(values="return.0")
@torch.no_grad()
def streamed_prefill(session: ForkSession, inputs: dict, cache: dict,
                     offset: int = 0):
    """Layer-by-layer prefill consuming weights as they arrive.

    Returns (last-token logits, filled cache) and equals
    ``transformer.prefill_from`` (``offset=0``: ``prefill``) exactly.  With
    ``offset`` the tokens are a prompt suffix at positions ``offset ..``
    over a cache whose first ``offset`` rows hold a reused prefix (dense
    and moe families only: a zamba or xlstm prefill starts at position
    0)."""
    model = session.model
    cfg = model.local_cfg
    if not supports_streamed_prefill(model):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family has no streamed prefill")
    with sharding.use_plan(model.plan, model.cfg):
        return _streamed_prefill(session, inputs, cache, offset, cfg)


def _streamed_prefill(session: ForkSession, inputs: dict, cache: dict,
                      offset: int, cfg):
    model = session.model
    tokens = torch.as_tensor(inputs["tokens"], device=model.device)
    B, S = tokens.shape
    offset = int(offset)
    if cfg.family in ("zamba", "xlstm"):
        if offset:
            raise ValueError(
                f"{cfg.name}: {cfg.family} has no suffix-only prefill "
                "(recurrent state is not position-addressable), got "
                f"offset={offset}")
        if cfg.family == "xlstm":
            return _streamed_prefill_xlstm(session, tokens, cache, cfg)
        return _streamed_prefill_zamba(session, tokens, cache, cfg)
    x = embed_tokens(session.leaf("embed"), tokens, scale_by_dim=cfg.scale_embed)
    positions = (offset + torch.arange(S, device=x.device))[None, :].expand(B, S)
    for layer in range(cfg.n_layers):
        x = transformer._dense_block(session.layer_params(layer), x, cfg,
                                     positions,
                                     transformer.layer_cache(cache, layer),
                                     offset)
    return _streamed_head(session, x), cache


def _streamed_prefill_zamba(session: ForkSession, tokens, cache: dict, cfg):
    """Zamba2 streamed prefill: per unit, ``attn_every`` Mamba2 blocks, each
    waiting only for its own layer's weights, then the SHARED attention +
    MLP block, fetched once (at the end of the first unit, where the traced
    order first needs it) and reused by every unit.  Runs
    ``transformer.zamba_unit``, the body of the monolithic prefill, with
    ``cfg`` the rank's configuration under a plan."""
    B, S = tokens.shape
    x = embed_tokens(session.leaf("embed"), tokens, scale_by_dim=cfg.scale_embed)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    shared: dict = {}

    def shared_params() -> dict:
        if not shared:
            shared.update(session.block_params("shared_attn"))
        return shared

    for unit in range(transformer.n_units(cfg)):
        x = transformer.zamba_unit(
            lambda layer: session.layer_params(layer, "mamba"), shared_params,
            x, cfg, positions, cache, unit, 0)
    return _streamed_head(session, x), cache


def _streamed_prefill_xlstm(session: ForkSession, tokens, cache: dict, cfg):
    """xLSTM streamed prefill, unit by unit: ``slstm_every - 1`` mLSTM
    blocks, then the unit's sLSTM block, each waiting only for its own
    weights.  Runs ``transformer.xlstm_unit``, the body of the monolithic
    prefill, which also takes several sequences one at a time; ``cfg`` is
    the rank's configuration under a plan."""
    if tokens.shape[0] > 1:
        logits = [_streamed_prefill_xlstm(session, tokens[b:b + 1],
                                          transformer.sequence_view(cache, b),
                                          cfg)[0]
                  for b in range(tokens.shape[0])]
        return torch.cat(logits), cache
    x = embed_tokens(session.leaf("embed"), tokens, scale_by_dim=cfg.scale_embed)
    for unit in range(transformer.xlstm_units(cfg)[0]):
        x = transformer.xlstm_unit(
            lambda layer: session.layer_params(layer, "mlstm"),
            lambda u: session.layer_params(u, "slstm"), x, cfg, cache, unit)
    return _streamed_head(session, x), cache


def _streamed_head(session: ForkSession, x):
    """The final norm and LM head over the last position (last-token
    logits), from the session's weights."""
    cfg = session.model.cfg
    x = rmsnorm(x[:, -1:], session.leaf("final_norm"), cfg.norm_eps)
    head = {"embed": session.leaf("embed")}
    if not cfg.tied_embeddings:
        head["lm_head"] = session.leaf("lm_head")
    return lm_head(x, head, cfg.tied_embeddings)[:, 0]
