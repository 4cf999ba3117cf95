"""Uniform model API of the port (the counterpart of ``repro.models.registry``).

    m = get_model("smollm-135m")                 # device="cuda" by default
    params = m.init_params(seed=0)
    logits, cache = m.prefill(params, {"tokens": toks}, m.make_cache(1, 64))
    logits, cache = m.decode_step_paged(params, arena, {"tokens": t}, pos,
                                        page_table, page_size)

A ``Model`` holds its device; every tensor it makes lives there.  With a
``plan`` (``distributed.sharding.ShardingPlan``) it is one rank's part of
a tensor-parallel model (under a training plan also its data-parallel
and FSDP part: ``forward(training=True)`` and ``loss`` of the dense and
moe families, MLA included, run on the rank's rows through
``distributed.fsdp``): its parameters, caches and arenas hold the
rank's shard (``local_cfg``: its heads, evenly or not
(``sharding.head_split``), ``d_ff`` and vocabulary slice,
a moe layer's experts and MLA's heads, the recurrent mixers' heads and
widths; MLA's latent arenas whole),
its calls run under ``sharding.use_plan`` and meet the other ranks in
their collectives, and the device ops below carry
``distributed.group.mirrored`` (on a controller they broadcast to the
workers; a model call's logits are what the controller reads of another
instance's ranks).  An adapter bank under a plan holds the rank's shard
(``models.adapters``): the q/k/v deltas are the rank's heads, and the wo
delta joins the rank's partial before the one ``all_reduce``.  ``init_params`` under a plan draws every full leaf from the
seed and keeps the rank's slice, so one seed gives the same weights at
every ``tp``.  The decoder families run ``models.transformer``, enc-dec (whisper)
``models.encdec`` (under a serving plan its ``prefill`` and
``decode_step`` run the rank's heads of the encoder and both
attentions; the sequential ``Engine`` takes no plan for it, as the
reference's), whose prefill inputs also carry ``frames`` [B, S_enc,
D] (cast to the model's dtype here, where the JAX package would promote
a bf16 model's encoder to the frames' fp32).  Inputs that are ``meta``
tensors (``input_specs``, tracing) pass through as they are.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed import fsdp, sharding
from repro_torch.distributed.group import mirrored
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig, reduced

ARCH_IDS = ["smollm-135m", "qwen3-14b", "qwen2.5-32b", "gemma-2b", "llama3-8b",
            "llama2-13b", "chameleon-34b", "llama2-70b", "phi3.5-moe-42b-a6.6b",
            "deepseek-v3-671b", "zamba2-2.7b", "xlstm-1.3b", "whisper-medium"]

_MODULE_FOR_ARCH = {a: a.replace(".", "_").replace("-", "_") for a in ARCH_IDS}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.

    Entry points default to ``"cuda"`` and raise here when there is no
    card: the port runs on the CPU only when the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device = "cuda"
    plan: Optional[Any] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        transformer.check_family(self.cfg)
        if self.plan is not None and not self.plan.distributed:
            self.plan = None
        if self.plan is not None and self.plan.training:
            self.plan = sharding.with_kv_groups(self.plan, self.cfg)
        self._local_cfg = (self.cfg if self.plan is None
                           else sharding.local_config(self.cfg, self.plan.tp,
                                                      self.plan.rank))
        self._layout = None

    @property
    def local_cfg(self) -> ModelConfig:
        """The configuration this rank computes with (``cfg`` at tp 1)."""
        return self._local_cfg

    def _scope(self):
        return sharding.use_plan(self.plan, self.cfg)

    def _training_scope(self, what: str):
        """The scope of a training call: none without a plan; under a
        training plan the rank's plan and its FSDP layout.  Raises for a
        serving plan and for a fused ``wqkv`` whose one KV head every rank
        shares (its gradient cannot be summed apart from q's)."""
        if self.plan is None:
            return contextlib.nullcontext()
        cfg = self.cfg
        if not self.plan.training:
            raise ValueError(f"{cfg.name}: {what} under a serving plan: "
                             "train under sharding.training_plan")
        tp = self.plan.tp
        split = (sharding.head_split(cfg, tp) if tp > 1 and not cfg.use_mla
                 else None)
        if cfg.fused_qkv and split is not None and (
                split.kv_whole or (not split.even and split.shared)):
            raise NotImplementedError(
                f"{cfg.name}: {cfg.n_kv_heads} KV head(s) shared by several "
                f"of {tp} ranks need their gradient summed over them, which "
                "a fused wqkv cannot take apart from q's: ROADMAP Queue 1, "
                "item 10")
        stack = contextlib.ExitStack()
        stack.enter_context(self._scope())
        stack.enter_context(fsdp.use_layout(self.layout))
        return stack

    @property
    def layout(self):
        """The FSDP layout of a model under a training plan (None
        otherwise)."""
        if self._layout is None and self.plan is not None and self.plan.training:
            self._layout = fsdp.Layout(
                self.plan, sharding.plan_param_specs(self.cfg, self.plan))
        return self._layout

    @property
    def dtype(self) -> torch.dtype:
        return transformer.torch_dtype(self.cfg.dtype)

    @property
    def is_encdec(self) -> bool:
        return self.cfg.is_encdec

    @property
    def _family(self):
        return encdec if self.is_encdec else transformer

    # ---- params / caches ------------------------------------------------
    def init_params(self, seed: int = 0, draw_on_device: bool = False) -> dict:
        """Random parameters from ``seed`` (see ``transformer.init_params``);
        under a plan the rank's shard of them.  ``draw_on_device`` draws
        on the model's device instead of the CPU: much faster for a
        full-width model, and the same weights for the same seed on one
        kind of device, not across devices."""
        if self.plan is None:
            return self._family.init_params(self.cfg, seed, self.device,
                                            draw_on_device=draw_on_device)
        specs = sharding.leaf_param_specs(self, self.plan.mesh)
        return self._family.init_params(
            self.cfg, seed, self.device, draw_on_device=draw_on_device,
            shard=lambda path, t: self.plan.shard(t, specs[path]))

    def param_specs(self) -> dict:
        """The parameter dict as shape-only ``meta`` tensors (the rank's
        shapes under a plan)."""
        return self._family.param_specs(self.local_cfg)

    @property
    def seq_split(self) -> bool:
        """True when this rank's attention cache holds a slice of the
        sequence axis (a ``prefer_seq`` plan over a GQA cache)."""
        return (self.plan is not None and self.plan.prefer_seq
                and self.plan.tp > 1 and sharding.seq_split_cache(self.cfg))

    def refuse_seq_split(self, what: str) -> None:
        """Raise for ``what`` (a pool, an engine, a suffix prefill) over
        a sequence-sharded cache."""
        if self.seq_split:
            raise NotImplementedError(
                f"{self.cfg.name}: {what} over a sequence-sharded cache "
                "(prefer_seq): only a prefill from position 0 and the dense "
                "decode step attend over it: ROADMAP Queue 1, item 10")

    @mirrored(register=("return",))
    def make_cache(self, batch: int, max_len: int, device=None) -> dict:
        """A dense cache on the model's device (or on ``device``: ``meta``
        for tracing).  Enc-dec: ``max_len`` is the encoder length (the
        cross K/V rows); the self cache has ``max_dec_len`` rows.  Under a
        ``prefer_seq`` plan the attention K/V leaves hold every KV head
        over this rank's ``max_len / tp`` positions (rank ``r``: positions
        ``[r max_len / tp, (r + 1) max_len / tp)``); MLA's latent stays
        whole and the recurrent states keep the rank's heads."""
        device = device or self.device
        if not self.seq_split:
            return self._family.make_cache(self.local_cfg, batch, max_len,
                                           device)
        tp, cfg = self.plan.tp, self.cfg
        if max_len % tp:
            raise ValueError(f"{cfg.name}: a sequence-sharded cache of "
                             f"{max_len} rows does not split over {tp} ranks")
        cache = transformer.make_cache(self.local_cfg, batch, max_len // tp,
                                       device)
        kv = cache["attn_kv"] if cfg.family == "zamba" else cache
        for name in ("k", "v"):
            shape = tuple(kv[name].shape[:3]) + (cfg.n_kv_heads, cfg.head_dim)
            kv[name] = torch.zeros(shape, dtype=kv[name].dtype, device=device)
        return cache

    @property
    def supports_paged_kv(self) -> bool:
        """True for families whose decode cache grows with sequence length
        (not enc-dec, whose self cache is fixed at ``max_dec_len``)."""
        return not self.is_encdec and transformer.supports_paged_kv(self.cfg)

    def _no_encdec(self, what: str) -> None:
        if self.is_encdec:
            raise ValueError(f"{self.cfg.name}: enc-dec has no {what}")

    @mirrored(register=("return",))
    def make_paged_cache(self, n_pages: int, page_size: int,
                         kv_dtype: str | None = None) -> dict:
        """Shared block-paged KV arena (see ``transformer.make_paged_cache``)."""
        self._no_encdec("paged KV layout")
        self.refuse_seq_split("a paged KV pool")
        return transformer.make_paged_cache(self.local_cfg, n_pages, page_size,
                                            self.device, kv_dtype)

    def input_specs(self, mode: str, batch: int, seq: int) -> dict:
        """``meta`` stand-ins for the inputs of ``prefill`` (``mode=
        'prefill'``) or ``decode_step`` (``'decode'``), as the JAX
        registry's ``input_specs`` gives them: tokens [batch, seq], or
        [batch, 1]; enc-dec's prefill also frames [batch, seq, d_model] in
        the model's dtype and tokens of ``min(max_dec_len, seq)``."""
        if mode not in ("prefill", "decode"):
            raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")

        def tokens(n):
            return torch.empty((batch, n), dtype=torch.int32, device="meta")

        if mode == "decode":
            return {"tokens": tokens(1)}
        if not self.is_encdec:
            return {"tokens": tokens(seq)}
        return {"frames": torch.empty((batch, seq, self.cfg.d_model),
                                      dtype=self.dtype, device="meta"),
                "tokens": tokens(min(self.cfg.max_dec_len, seq))}

    # ---- entry points ------------------------------------------------------
    def _input(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, torch.Tensor) and x.is_meta:
            return x if dtype is None else x.to(dtype)
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _tokens(self, inputs: dict) -> torch.Tensor:
        return self._input(inputs["tokens"])

    def _frames(self, inputs: dict) -> torch.Tensor:
        if "frames" not in inputs:
            raise ValueError(f"{self.cfg.name}: enc-dec inputs need 'frames'")
        return self._input(inputs["frames"], self.dtype)

    # ---- training ----------------------------------------------------------
    def forward(self, params, inputs: dict, training: bool = False):
        """Full-sequence forward -> (logits, aux).  ``training=True`` is the
        training forward (gradients, remat); the default runs under
        ``no_grad``.  Under a training plan: the rank's rows in, the
        logits of the whole vocabulary out."""
        with self._training_scope("the full-sequence forward"):
            if self.is_encdec:
                return encdec.forward(params, self.local_cfg,
                                      self._frames(inputs),
                                      self._tokens(inputs), training)
            return transformer.forward(params, self.local_cfg,
                                       self._tokens(inputs), training)

    def loss(self, params, batch: dict) -> torch.Tensor:
        """The training loss of ``batch`` (``tokens``, ``labels`` and, for
        enc-dec, ``frames``), as the reference's ``Model.loss``."""
        with self._training_scope("the training loss"):
            labels = self._input(batch["labels"])
            if self.is_encdec:
                return encdec.loss_fn(params, self.local_cfg,
                                      self._frames(batch),
                                      self._tokens(batch), labels)
            return transformer.loss_fn(params, self.local_cfg,
                                       self._tokens(batch), labels)

    # ---- serving -----------------------------------------------------------

    def _ids(self, adapter_ids):
        if adapter_ids is None:
            return None
        return torch.as_tensor(adapter_ids, dtype=torch.int32,
                               device=self.device)

    @mirrored(values="return.0")
    def prefill(self, params, inputs: dict, cache, adapter_bank=None,
                adapter_ids=None):
        """Whole-prompt prefill; with an ``adapter_bank``, ``adapter_ids``
        [B] selects each sequence's LoRA row.  Enc-dec: encode
        ``inputs['frames']``, then the prompt."""
        if self.is_encdec:
            with self._scope():
                return encdec.prefill(params, self.local_cfg,
                                      self._frames(inputs),
                                      self._tokens(inputs), cache)
        with self._scope():
            return transformer.prefill(params, self.local_cfg,
                                       self._tokens(inputs), cache,
                                       adapter_bank, self._ids(adapter_ids))

    @mirrored(values="return.0")
    def prefill_from(self, params, inputs: dict, cache, offset: int,
                     adapter_bank=None, adapter_ids=None):
        """Suffix-only prefill against a cache holding a reused prompt
        prefix of ``offset`` tokens."""
        self._no_encdec("suffix-only prefill")
        self.refuse_seq_split("a suffix or chunked prefill")
        with self._scope():
            return transformer.prefill_from(params, self.local_cfg,
                                            self._tokens(inputs), cache,
                                            offset, adapter_bank,
                                            self._ids(adapter_ids))

    @mirrored(values="return.0")
    def decode_step(self, params, cache, inputs: dict, pos):
        """One decode step; ``pos`` an int or an int [B] vector (enc-dec:
        a scalar only, the whole batch at one decoder position)."""
        if self.is_encdec:
            if np.ndim(pos.cpu() if isinstance(pos, torch.Tensor) else pos):
                raise ValueError(
                    f"{self.cfg.name}: enc-dec decodes the whole batch at one "
                    "position; pos must be a scalar")
            with self._scope():
                return encdec.decode_step(params, self.local_cfg, cache,
                                          self._tokens(inputs), int(pos))
        with self._scope():
            return transformer.decode_step(params, self.local_cfg, cache,
                                           self._tokens(inputs), pos)

    @mirrored(values="return.0")
    def decode_step_paged(self, params, cache, inputs: dict, pos, page_table,
                          page_size: int, adapter_bank=None, adapter_ids=None):
        """One decode step over a block-paged arena: ``pos`` int [B] and
        ``page_table`` [B, NB] int32 on the model's device; with an
        ``adapter_bank``, ``adapter_ids`` [B] picks each slot's LoRA row."""
        self._no_encdec("paged decode path")
        self.refuse_seq_split("the paged decode step")
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device)
        page_table = torch.as_tensor(page_table, dtype=torch.int32,
                                     device=self.device)
        with self._scope():
            return transformer.decode_step_paged(params, self.local_cfg, cache,
                                                 self._tokens(inputs), pos,
                                                 page_table, page_size,
                                                 adapter_bank,
                                                 self._ids(adapter_ids))


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR_ARCH[arch]}")
    return mod.CONFIG


def get_model(arch_or_cfg, device="cuda", plan=None) -> Model:
    """A ``Model`` on ``device`` (one rank's part under ``plan``); raises
    when asked for a card that is absent."""
    if isinstance(arch_or_cfg, ModelConfig):
        return Model(arch_or_cfg, device, plan)
    return Model(get_config(arch_or_cfg), device, plan)


def get_smoke_model(arch: str, device="cuda", plan=None, **extra) -> Model:
    return Model(reduced(get_config(arch), **extra), device, plan)


# The ten architectures of the cost tables, in the reference registry's
# order (its ARCH_IDS[:10]; the llama family is the paper's own and stays out)
CELL_ARCHS = ("xlstm-1.3b", "gemma-2b", "qwen3-14b", "qwen2.5-32b",
              "smollm-135m", "zamba2-2.7b", "phi3.5-moe-42b-a6.6b",
              "deepseek-v3-671b", "chameleon-34b", "whisper-medium")

# Shape set assigned to the LM pool (seq_len, global_batch).
SHAPES = {
    "train_4k": dict(mode="train", seq=4096, batch=256),
    "prefill_32k": dict(mode="prefill", seq=32768, batch=32),
    "decode_32k": dict(mode="decode", seq=32768, batch=128),
    "long_500k": dict(mode="decode", seq=524288, batch=1),
}


def long_context_capable(cfg: ModelConfig) -> bool:
    """long_500k needs sub-quadratic attention: ssm/hybrid only."""
    return cfg.attention_kind in ("recurrent", "hybrid")


def cells(archs=None) -> list[tuple[str, str]]:
    """All (arch, shape) cells of the analytic cost tables, with the
    long_500k skips of quadratic-attention archs."""
    out = []
    for a in archs or CELL_ARCHS:
        cfg = get_config(a)
        for s in SHAPES:
            if s == "long_500k" and not long_context_capable(cfg):
                continue
            out.append((a, s))
    return out
