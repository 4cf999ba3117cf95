"""Synthetic data from a seed: the token stream that training draws, and
serving's prompts and frames (the port's copies of ``repro.data.pipeline``:
the same seed gives the same numbers in both packages).

Everything is made on the host with numpy (no dataset download), shaped
like a real pipeline: a host-sharded stream of packed language-model
batches with a resumable position.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2          # zipfian token distribution (LM-like)


class TokenStream:
    """Resumable, host-sharded stream of packed LM batches: ``{'tokens',
    'labels'}`` int32 [global_batch / n_hosts, seq_len], labels the tokens
    shifted by one.  ``state()`` / ``restore()`` give exact resume, so a
    run restarted from a checkpoint sees the same batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._step = 0

    def state(self) -> dict:
        return {"step": self._step}

    def restore(self, state: dict) -> None:
        self._step = int(state["step"])

    def _batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, cfg.host_id))
        per_host = cfg.global_batch // cfg.n_hosts
        # zipf folded back into the vocabulary
        toks = rng.zipf(cfg.zipf_a, size=(per_host, cfg.seq_len + 1))
        toks = (toks - 1) % cfg.vocab_size
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self._batch_at(self._step)
            self._step += 1
            yield b


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
