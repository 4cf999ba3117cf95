"""Uniform model API of the port (the counterpart of ``repro.models.registry``).

    m = get_model("smollm-135m")                 # device="cuda" by default
    params = m.init_params(seed=0)
    logits, cache = m.prefill(params, {"tokens": toks}, m.make_cache(1, 64))
    logits, cache = m.decode_step_paged(params, arena, {"tokens": t}, pos,
                                        page_table, page_size)

A ``Model`` holds its device; every tensor it makes lives there.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, reduced

ARCH_IDS = ["smollm-135m", "qwen3-14b", "qwen2.5-32b", "gemma-2b", "llama3-8b",
            "llama2-13b", "chameleon-34b", "llama2-70b", "phi3.5-moe-42b-a6.6b",
            "deepseek-v3-671b", "zamba2-2.7b", "xlstm-1.3b"]

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

    # ---- params / caches ------------------------------------------------
    def init_params(self, seed: int = 0) -> dict:
        return transformer.init_params(self.cfg, seed, self.device)

    def param_specs(self) -> dict:
        """The parameter dict as shape-only ``meta`` tensors."""
        return transformer.param_specs(self.cfg)

    def make_cache(self, batch: int, max_len: int) -> dict:
        return transformer.make_cache(self.cfg, batch, max_len, self.device)

    @property
    def supports_paged_kv(self) -> bool:
        """True for families whose decode cache grows with sequence length."""
        return transformer.supports_paged_kv(self.cfg)

    def make_paged_cache(self, n_pages: int, page_size: int,
                         kv_dtype: str | None = None) -> dict:
        """Shared block-paged KV arena (see ``transformer.make_paged_cache``)."""
        return transformer.make_paged_cache(self.cfg, n_pages, page_size,
                                            self.device, kv_dtype)

    # ---- entry points ------------------------------------------------------
    def _tokens(self, inputs: dict) -> torch.Tensor:
        return torch.as_tensor(inputs["tokens"], device=self.device)

    def forward(self, params, inputs: dict):
        return transformer.forward(params, self.cfg, self._tokens(inputs))

    def _ids(self, adapter_ids):
        if adapter_ids is None:
            return None
        return torch.as_tensor(adapter_ids, dtype=torch.int32,
                               device=self.device)

    def prefill(self, params, inputs: dict, cache, adapter_bank=None,
                adapter_ids=None):
        """Whole-prompt prefill; with an ``adapter_bank``, ``adapter_ids``
        [B] selects each sequence's LoRA row."""
        return transformer.prefill(params, self.cfg, self._tokens(inputs), cache,
                                   adapter_bank, self._ids(adapter_ids))

    def prefill_from(self, params, inputs: dict, cache, offset: int,
                     adapter_bank=None, adapter_ids=None):
        """Suffix-only prefill against a cache holding a reused prompt
        prefix of ``offset`` tokens."""
        return transformer.prefill_from(params, self.cfg, self._tokens(inputs),
                                        cache, offset, adapter_bank,
                                        self._ids(adapter_ids))

    def decode_step(self, params, cache, inputs: dict, pos):
        """One decode step; ``pos`` an int or an int [B] vector."""
        return transformer.decode_step(params, self.cfg, cache,
                                       self._tokens(inputs), pos)

    def decode_step_paged(self, params, cache, inputs: dict, pos, page_table,
                          page_size: int, adapter_bank=None, adapter_ids=None):
        """One decode step over a block-paged arena: ``pos`` int [B] and
        ``page_table`` [B, NB] int32 on the model's device; with an
        ``adapter_bank``, ``adapter_ids`` [B] picks each slot's LoRA row."""
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
