"""Synthetic prompts from a seed (the port's copy of
``repro.data.pipeline.make_prompts``: the same seed gives the same
tokens in both packages)."""

from __future__ import annotations

import numpy as np


def make_prompts(vocab_size: int, batch: int, length: int,
                 seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab_size, size=(batch, length)).astype(np.int32)
