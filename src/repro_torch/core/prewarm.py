"""Proactive code-segment loading (TIDAL §5.1), port edition.

On a card the first call of an entry point at a new shape pays more than
its arithmetic: the CUDA context, the lazy module loads of PyTorch's own
kernels (``CUDA_MODULE_LOADING=LAZY``, the ~180 ms cold-kernel cost the
paper measures), the cuBLAS handle, and the load of this port's kernel
library (``kernels/_build.library()``).  TIDAL's fix is to warm exactly
the kernels the traced template names before any invocation.  Here
"compiling" an executable means running the entry point once at that
shape on zero-filled inputs; ``ExecutableCache`` keys and counts those
warm-ups as the JAX package's cache keys and counts its AOT compiles, so
the same deploys give the same hits and misses.

The loading policy carries over: a worker warms the entry points of
exactly the functions cached in its host pool.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.distributed.group import mirrored
from repro_torch.kernels import _build
from repro_torch.utils import map_with_path


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    compile_s: float = 0.0


class ExecutableCache:
    """Warmed entry points, keyed like the JAX package's executables."""

    def __init__(self):
        self._cache: dict = {}
        self.stats = CacheStats()

    def __contains__(self, key) -> bool:
        return key in self._cache

    def keys(self):
        return list(self._cache)

    def get_or_compile(self, key, build: Callable[[], Any]):
        """``build()`` warms the entry point and returns it."""
        if key in self._cache:
            self.stats.hits += 1
            return self._cache[key]
        t0 = time.perf_counter()
        exe = build()
        self.stats.compile_s += time.perf_counter() - t0
        self.stats.misses += 1
        self._cache[key] = exe
        return exe


def warm_device(device: torch.device) -> None:
    """Create the CUDA context on ``device`` and load the kernel library
    (nothing to do on the CPU)."""
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        _build.library()


@dataclasses.dataclass
class Worker:
    """A pre-warmed worker: context created, selected entry points loaded."""
    worker_id: int
    device: torch.device = torch.device("cuda")
    ctx_ready: bool = False
    loaded: set = dataclasses.field(default_factory=set)

    def prewarm_ctx(self) -> None:
        warm_device(self.device)
        self.ctx_ready = True

    def load_executables(self, keys) -> None:
        self.loaded |= set(keys)


class ProcessPool:
    """Pool of pre-warmed workers following the §5.1 loading policy: each
    worker warms the entry points of the functions whose weights are
    cached in this host's pool.  Workers warm the card unless the caller
    passes ``device="cpu"``."""

    def __init__(self, size: int, cache: ExecutableCache, device="cuda"):
        self.cache = cache
        self.workers = [Worker(i, torch.device(device)) for i in range(size)]
        for w in self.workers:
            w.prewarm_ctx()
        self._free = list(self.workers)

    def prewarm_for_functions(self, fn_keys: dict) -> None:
        """fn_keys: function name -> list of entry-point cache keys."""
        keys = [k for ks in fn_keys.values() for k in ks]
        for w in self.workers:
            w.load_executables(keys)

    def acquire(self) -> Optional[Worker]:
        return self._free.pop() if self._free else None

    def release(self, w: Worker) -> None:
        self._free.append(w)

    def is_prewarmed(self, w: Worker, keys) -> bool:
        """The worker's context is up and it has loaded every key."""
        return w.ctx_ready and set(keys) <= w.loaded


@mirrored(register=("return",))
def zero_params(model) -> dict:
    """Zero-filled parameters of ``model`` on its device (warm-up input;
    the rank's shapes under a sharding plan).
    Leaves of one shape and dtype share one zero tensor (warm-ups only
    read them), so every layer reads the same buffers: the warm-up input
    of llama2-13b takes ~1 GB, not a second 26 GB copy of the model."""
    zeros: dict = {}

    def zero(_, spec):
        key = (tuple(spec.shape), spec.dtype)
        if key not in zeros:
            zeros[key] = torch.zeros(key[0], dtype=spec.dtype,
                                     device=model.device)
        return zeros[key]

    return map_with_path(zero, model.param_specs())


def prewarm_function(cache: ExecutableCache, model, fn_name: str,
                     batch: int, seq: int, max_len: Optional[int] = None):
    """Warm a function's prefill and dense decode at one shape ahead of
    invocation.  Returns the cache keys (what the pool loads)."""
    max_len = max_len or seq * 2
    zeros = functools.cache(lambda: zero_params(model))
    kp = (fn_name, "prefill", batch, seq, max_len)
    kd = (fn_name, "decode", batch, max_len)

    def warm_prefill():
        toks = torch.zeros((batch, seq), dtype=torch.int32, device=model.device)
        model.prefill(zeros(), {"tokens": toks},
                      model.make_cache(batch, max_len))
        return model.prefill

    def warm_decode():
        toks = torch.zeros((batch, 1), dtype=torch.int32, device=model.device)
        model.decode_step(zeros(), model.make_cache(batch, max_len),
                          {"tokens": toks}, 0)
        return model.decode_step

    warm_device(model.device)
    cache.get_or_compile(kp, warm_prefill)
    cache.get_or_compile(kd, warm_decode)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return [kp, kd]
