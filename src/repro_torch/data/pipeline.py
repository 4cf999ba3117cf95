"""Synthetic prompts and frames from a seed (the port's copies of
``repro.data.pipeline.make_prompts`` and ``make_frames``: the same seed
gives the same numbers in both packages)."""

from __future__ import annotations

import numpy as np


def make_prompts(vocab_size: int, batch: int, length: int,
                 seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab_size, size=(batch, length)).astype(np.int32)


def make_frames(d_model: int, batch: int, length: int, seed: int = 0,
                dtype=np.float32) -> np.ndarray:
    """Whisper frontend stub: precomputed frame embeddings [batch, length,
    d_model]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, length, d_model)) * 0.02).astype(dtype)
