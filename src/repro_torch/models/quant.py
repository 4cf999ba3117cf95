"""Symmetric int8 row quantization for the paged KV arena.

One "row" is the innermost feature vector of a cache leaf — a single
(position, kv_head) head_dim vector — and each row carries its own float32
scale (absmax / 127).  The transform is exactly idempotent through a round
trip, ``quantize(dequantize(q, s)) == (q, s)``, because a row's absmax
element always lands on ±127 (or the scale floor re-engages for all-zero
rows).  Copy-on-write page copies and chunked prefill's first-block
rewrites rely on that.  The operation order follows the JAX reference so
both packages produce the same int8 bits: divide by the scale (not a
multiply by its reciprocal), round half to even, clip to ±127.

Scale leaves ride inside the cache dict under ``<leaf>_scale`` keys,
shaped like the value leaf minus its last axis.
"""

from __future__ import annotations

import torch

SCALE_SUFFIX = "_scale"

# absmax floor: rows of exact zeros (null page, never-written tail) keep a
# representable scale and re-engage the same floor on re-quantization
_EPS = 1e-8


def is_quantized_cache(cache: dict) -> bool:
    """True when ``cache`` carries int8 values + per-row scale leaves."""
    return any(k.endswith(SCALE_SUFFIX) for k in cache)


def value_keys(cache: dict) -> list:
    """The non-scale keys of a (possibly quantized) cache dict."""
    return [k for k in cache if not k.endswith(SCALE_SUFFIX)]


def quantize_rows(x: torch.Tensor):
    """Quantize ``[..., d]`` rows to (int8 ``[..., d]``, float32 ``[...]``)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), _EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Expand int8 rows back to ``dtype``: ``q * scale`` per row."""
    return (q.float() * scale.float()[..., None]).to(dtype)
