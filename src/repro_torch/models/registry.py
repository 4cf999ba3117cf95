"""Uniform model API of the port (the counterpart of ``repro.models.registry``).

    m = get_model("smollm-135m")                 # device="cuda" by default
    params = m.init_params(seed=0)
    logits, cache = m.prefill(params, {"tokens": toks}, m.make_cache(1, 64))
    logits, cache = m.decode_step_paged(params, arena, {"tokens": t}, pos,
                                        page_table, page_size)

A ``Model`` holds its device; every tensor it makes lives there.  The
decoder families run ``models.transformer``, enc-dec (whisper)
``models.encdec``, whose prefill inputs also carry ``frames`` [B, S_enc,
D] (cast to the model's dtype here, where the JAX package would promote
a bf16 model's encoder to the frames' fp32).  Inputs that are ``meta``
tensors (``input_specs``, tracing) pass through as they are.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

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

    def __post_init__(self):
        self.device = resolve_device(self.device)
        transformer.check_family(self.cfg)

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
    def init_params(self, seed: int = 0) -> dict:
        return self._family.init_params(self.cfg, seed, self.device)

    def param_specs(self) -> dict:
        """The parameter dict as shape-only ``meta`` tensors."""
        return self._family.param_specs(self.cfg)

    def make_cache(self, batch: int, max_len: int, device=None) -> dict:
        """A dense cache on the model's device (or on ``device``: ``meta``
        for tracing).  Enc-dec: ``max_len`` is the encoder length (the
        cross K/V rows); the self cache has ``max_dec_len`` rows."""
        return self._family.make_cache(self.cfg, batch, max_len,
                                       device or self.device)

    @property
    def supports_paged_kv(self) -> bool:
        """True for families whose decode cache grows with sequence length
        (not enc-dec, whose self cache is fixed at ``max_dec_len``)."""
        return not self.is_encdec and transformer.supports_paged_kv(self.cfg)

    def _no_encdec(self, what: str) -> None:
        if self.is_encdec:
            raise ValueError(f"{self.cfg.name}: enc-dec has no {what}")

    def make_paged_cache(self, n_pages: int, page_size: int,
                         kv_dtype: str | None = None) -> dict:
        """Shared block-paged KV arena (see ``transformer.make_paged_cache``)."""
        self._no_encdec("paged KV layout")
        return transformer.make_paged_cache(self.cfg, n_pages, page_size,
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
        ``no_grad``."""
        if self.is_encdec:
            return encdec.forward(params, self.cfg, self._frames(inputs),
                                  self._tokens(inputs), training)
        return transformer.forward(params, self.cfg, self._tokens(inputs),
                                   training)

    def loss(self, params, batch: dict) -> torch.Tensor:
        """The training loss of ``batch`` (``tokens``, ``labels`` and, for
        enc-dec, ``frames``), as the reference's ``Model.loss``."""
        labels = self._input(batch["labels"])
        if self.is_encdec:
            return encdec.loss_fn(params, self.cfg, self._frames(batch),
                                  self._tokens(batch), labels)
        return transformer.loss_fn(params, self.cfg, self._tokens(batch), labels)

    # ---- serving -----------------------------------------------------------

    def _ids(self, adapter_ids):
        if adapter_ids is None:
            return None
        return torch.as_tensor(adapter_ids, dtype=torch.int32,
                               device=self.device)

    def prefill(self, params, inputs: dict, cache, adapter_bank=None,
                adapter_ids=None):
        """Whole-prompt prefill; with an ``adapter_bank``, ``adapter_ids``
        [B] selects each sequence's LoRA row.  Enc-dec: encode
        ``inputs['frames']``, then the prompt."""
        if self.is_encdec:
            return encdec.prefill(params, self.cfg, self._frames(inputs),
                                  self._tokens(inputs), cache)
        return transformer.prefill(params, self.cfg, self._tokens(inputs), cache,
                                   adapter_bank, self._ids(adapter_ids))

    def prefill_from(self, params, inputs: dict, cache, offset: int,
                     adapter_bank=None, adapter_ids=None):
        """Suffix-only prefill against a cache holding a reused prompt
        prefix of ``offset`` tokens."""
        self._no_encdec("suffix-only prefill")
        return transformer.prefill_from(params, self.cfg, self._tokens(inputs),
                                        cache, offset, adapter_bank,
                                        self._ids(adapter_ids))

    def decode_step(self, params, cache, inputs: dict, pos):
        """One decode step; ``pos`` an int or an int [B] vector (enc-dec:
        a scalar only, the whole batch at one decoder position)."""
        if self.is_encdec:
            if np.ndim(pos.cpu() if isinstance(pos, torch.Tensor) else pos):
                raise ValueError(
                    f"{self.cfg.name}: enc-dec decodes the whole batch at one "
                    "position; pos must be a scalar")
            return encdec.decode_step(params, self.cfg, cache,
                                      self._tokens(inputs), int(pos))
        return transformer.decode_step(params, self.cfg, cache,
                                       self._tokens(inputs), pos)

    def decode_step_paged(self, params, cache, inputs: dict, pos, page_table,
                          page_size: int, adapter_bank=None, adapter_ids=None):
        """One decode step over a block-paged arena: ``pos`` int [B] and
        ``page_table`` [B, NB] int32 on the model's device; with an
        ``adapter_bank``, ``adapter_ids`` [B] picks each slot's LoRA row."""
        self._no_encdec("paged decode path")
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device)
        page_table = torch.as_tensor(page_table, dtype=torch.int32,
                                     device=self.device)
        return transformer.decode_step_paged(params, self.cfg, cache,
                                             self._tokens(inputs), pos,
                                             page_table, page_size, adapter_bank,
                                             self._ids(adapter_ids))


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR_ARCH[arch]}")
    return mod.CONFIG


def get_model(arch_or_cfg, device="cuda") -> Model:
    """A ``Model`` on ``device``; raises when asked for a card that is absent."""
    if isinstance(arch_or_cfg, ModelConfig):
        return Model(arch_or_cfg, device)
    return Model(get_config(arch_or_cfg), device)


def get_smoke_model(arch: str, device="cuda", **extra) -> Model:
    return Model(reduced(get_config(arch), **extra), device)
