"""Token sampling for the serving engines.

Only the two samplers the continuous-batching engine needs are ported so
far; the sequential ``Engine`` arrives with the ``decode_attention`` slice.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocabulary (first maximum on ties), as int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


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
