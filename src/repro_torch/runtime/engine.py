"""Sequential serving engine and token samplers.

``Engine`` runs one fixed-shape batch to completion, prefill then decode,
over a dense cache: the port's counterpart of ``repro.runtime.engine.
Engine``, and the reference the batching engines are tested against (the
continuous engine reproduces its greedy tokens request by request).  Its
decode steps run the ``decode_attention`` kernel on a card.  It is also
the one engine that serves enc-dec (whisper): ``generate(frames=)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models.registry import Model


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray           # [B, n_generated]
    ttft_s: float                # wall time to first token (prefill)
    decode_s: float              # wall time for the remaining tokens
    n_prompt: int
    n_generated: int


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocabulary (first maximum on ties), as int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_temperature(logits: torch.Tensor, gen: torch.Generator,
                       temperature: float = 1.0) -> torch.Tensor:
    """One categorical draw per row of ``logits / temperature`` from
    ``gen`` (a ``torch.Generator`` on the logits' device), as int32.  The
    draws differ from ``jax.random.categorical``'s for the same seed."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def sample_token(logits, temperature: float, top_p: float,
                 seed: int, step: int) -> int:
    """Temperature/top-p sampling for ONE logits row, deterministically
    seeded per (request seed, emission index) with numpy, so it picks the
    same token as ``repro.runtime.engine.sample_token`` for the same
    logits.  ``top_p`` keeps the smallest token set whose cumulative
    probability reaches it (always at least the argmax)."""
    z = np.asarray(logits, np.float64) / max(temperature, 1e-8)
    z -= z.max()
    probs = np.exp(z)
    probs /= probs.sum()
    if top_p < 1.0:
        order = np.argsort(-probs, kind="stable")
        csum = np.cumsum(probs[order])
        keep = order[:int(np.searchsorted(csum, top_p)) + 1]
        mask = np.zeros_like(probs)
        mask[keep] = 1.0
        probs *= mask
        probs /= probs.sum()
    rng = np.random.default_rng((seed, step))
    return int(rng.choice(len(probs), p=probs))


class Engine:
    """Batched generation for one model over a dense cache.

    ``prefill_fn(params, inputs, cache)`` and ``decode_fn(params, cache,
    inputs, pos)`` can be injected (warmed entry points, as TIDAL's
    proactive code loading provides); by default they are the model's own
    ``prefill`` and ``decode_step``.  The cache is updated in place, so no
    step copies it.

    Greedy decoding (the default) is the parity reference: the same
    weights give the JAX ``Engine``'s tokens.  ``greedy=False`` draws with
    an explicit ``torch.Generator`` seeded by ``seed``, which cannot match
    ``jax.random`` draw for draw.
    """

    def __init__(self, model: Model, params: Any,
                 prefill_fn: Optional[Callable] = None,
                 decode_fn: Optional[Callable] = None):
        if getattr(model, "seq_split", False):
            model.refuse_seq_split("the Engine")
        if model.is_encdec and model.plan is not None:
            raise NotImplementedError(
                f"{model.cfg.name}: the sequential Engine takes no sharding "
                "plan for enc-dec (as the reference's Engine; its continuous "
                "engine refuses enc-dec); under a plan call Model.prefill "
                "and decode_step")
        self.model = model
        self.params = params
        self.prefill_fn = prefill_fn or model.prefill
        self.decode_fn = decode_fn or model.decode_step

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 16,
                 frames: Optional[np.ndarray] = None,
                 greedy: bool = True, seed: int = 0,
                 cache_len: Optional[int] = None,
                 temperature: float = 1.0,
                 on_token: Optional[Callable] = None) -> GenerationResult:
        """Prefill ``prompts`` [B, S], then decode ``max_new_tokens - 1``
        more tokens.  ``on_token(tokens, index)`` is called with each
        sampled [B] token batch as it is produced.

        Enc-dec: ``frames`` [B, S_enc, D] go into the prefill inputs, the
        cross cache takes their S_enc rows (``cache_len`` is unused), and
        decoder positions continue after the prompt tokens.  Positions
        past ``max_dec_len`` raise ``ValueError`` (the JAX engine's
        ``dynamic_slice`` would clamp them to the last row)."""
        prompts = np.asarray(prompts, np.int32)
        B, S = prompts.shape
        dev = self.model.device
        inputs = {"tokens": torch.as_tensor(prompts, device=dev)}
        if self.model.is_encdec:
            if frames is None:
                raise ValueError(f"{self.model.cfg.name}: enc-dec generation "
                                 "needs frames")
            limit = self.model.cfg.max_dec_len
            if S + max_new_tokens - 1 > limit:
                raise ValueError(
                    f"{self.model.cfg.name}: prompt({S}) + max_new"
                    f"({max_new_tokens}) - 1 decoder positions exceed "
                    f"max_dec_len={limit}")
            inputs["frames"] = torch.as_tensor(frames, device=dev)
            cache = self.model.make_cache(B, inputs["frames"].shape[1])
        else:
            cache = self.model.make_cache(B, cache_len or (S + max_new_tokens))
        gen = None
        if not greedy:
            gen = torch.Generator(device=dev).manual_seed(seed)

        def sample(logits):
            if greedy:
                return sample_greedy(logits)
            return sample_temperature(logits, gen, temperature)

        t0 = time.perf_counter()
        logits, cache = self.prefill_fn(self.params, inputs, cache)
        tok = sample(logits)
        out = [tok.cpu().numpy()]                  # synchronises the card
        ttft = time.perf_counter() - t0
        if on_token is not None:
            on_token(out[0], 0)
        t1 = time.perf_counter()
        for i in range(1, max_new_tokens):
            logits, cache = self.decode_fn(self.params, cache,
                                           {"tokens": tok[:, None]}, S + i - 1)
            tok = sample(logits)
            out.append(tok.cpu().numpy())
            if on_token is not None:
                on_token(out[-1], i)
        decode_s = time.perf_counter() - t1
        return GenerationResult(
            tokens=np.stack(out, axis=1), ttft_s=ttft, decode_s=decode_s,
            n_prompt=S, n_generated=max_new_tokens)
