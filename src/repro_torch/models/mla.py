"""Multi-head Latent Attention (DeepSeek-V2/V3), the port's copy of
``repro.models.mla`` with the same semantics.

The KV cache holds only the compressed latent ``c_kv`` (kv_lora_rank
wide) and the decoupled RoPE key ``k_rope`` (qk_rope_dim wide), one row
of each per token: the paper's cache saving.  Decode attends in latent
space: the per-head nope keys and values are re-expanded from the latent
through ``wkv_b`` on every call (the absorbed-matmul form is not in the
reference, so it is not here either).

Four cache modes, as in the reference:

* no cache: causal attention over ``x`` itself;
* dense ``{'c_kv': [B, T, kvr], 'k_rope': [B, T, dr]}`` with an int
  ``cache_pos``: rows ``cache_pos ..`` written in place, then attention
  over the first ``cache_pos + S`` rows (the reference attends over all
  ``T`` rows; the rows past ``cache_pos + S`` are masked and add exactly
  0, so the result is the reference's and its cost does not grow with the
  cache's padded length);
* dense with a ``[B]`` tensor ``cache_pos`` (decode only): each sequence's
  row written at its own position, attention over all ``T`` rows;
* paged (``page_table`` given, decode only): the cache leaves are shared
  arenas ``[P, page_size, kvr]`` / ``[P, page_size, dr]`` (an int8 arena
  also has ``c_kv_scale`` / ``k_rope_scale`` ``[P, page_size]``, one fp32
  scale per cached row, quantized on write); the token's rows land in the
  page its table maps and attention runs over the ``NB * page_size`` rows
  the table gathers.

dtypes follow the reference: the projections and the re-expansion run in
the model dtype; the scores, softmax and ``probs @ v`` in fp32; the
output is cast back before ``wo``.  Every op here is a PyTorch op (the
reference runs MLA in XLA, outside any Pallas kernel) except the three
RMSNorms per block, which go to the ``rmsnorm`` kernel on a card;
``kv_a_norm`` reads a strided view of the ``wkv_a`` product (rows of
``kvr`` at a row stride of ``kvr + dr``) without a copy.

Under a sharding plan (head parallelism) ``cfg`` is the rank's
configuration with ``H / tp`` heads and ``wq_b`` / ``wkv_b`` hold those
heads' columns: the a-side products and their norms run replicated, the
latent cache is whole on every rank (every head reads all of it), and
``out @ wo`` is a row-parallel partial summed over the ranks by one
``all_reduce``.  For training, the replicated a-side's outputs enter the
rank's heads through ``sharding.copy_to_model`` (the query latent before
``wq_b``, the KV latent before ``wkv_b``, the rope key before the
scores), so its gradient is every head's, summed over the ranks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import quant
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDraw, normal_, rmsnorm, rope


def make_mla_params(gen: Optional[ParamDraw], cfg: ModelConfig) -> dict:
    """The MLA projections, drawn in the reference's order (norms ones)."""
    D, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": normal_(gen, (D, qr)),
        "q_a_norm": torch.ones(qr),
        "wq_b": normal_(gen, (qr, H * (dn + dr))),
        "wkv_a": normal_(gen, (D, kvr + dr)),
        "kv_a_norm": torch.ones(kvr),
        "wkv_b": normal_(gen, (kvr, H * (dn + dv))),
        "wo": normal_(gen, (H * dv, D)),
    }


def _paged_rows(arena: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """The rows ``page_table`` [B, NB] maps, as ``[B, NB * page_size, ...]``."""
    B, NB = page_table.shape
    rows = arena[page_table.long()]                 # [B, NB, ps, ...]
    return rows.reshape((B, NB * arena.shape[1]) + tuple(arena.shape[2:]))


def _write_paged(kv_cache: dict, c_kv, k_rope, page_table, cache_pos,
                 page_size: int) -> tuple:
    """Write one token's latent and rope-key rows per sequence into the
    arena in place (quantized for an int8 arena); returns the rows the
    page table maps, in the model dtype: (latent [B, T, kvr], rope keys
    [B, T, dr])."""
    B = c_kv.shape[0]
    pages = page_table[torch.arange(B, device=c_kv.device),
                       (cache_pos // page_size).long()].long()
    off = (cache_pos % page_size).long()
    cc, cr = kv_cache["c_kv"], kv_cache["k_rope"]
    if quant.is_quantized_cache(kv_cache):
        ccs, crs = kv_cache["c_kv_scale"], kv_cache["k_rope_scale"]
        qc, sc = quant.quantize_rows(c_kv[:, 0])          # [B, kvr], [B]
        qr, sr = quant.quantize_rows(k_rope[:, 0])
        cc[pages, off] = qc
        cr[pages, off] = qr
        ccs[pages, off] = sc
        crs[pages, off] = sr
        return (quant.dequantize_rows(_paged_rows(cc, page_table),
                                      _paged_rows(ccs, page_table), c_kv.dtype),
                quant.dequantize_rows(_paged_rows(cr, page_table),
                                      _paged_rows(crs, page_table), c_kv.dtype))
    cc[pages, off] = c_kv[:, 0].to(cc.dtype)
    cr[pages, off] = k_rope[:, 0].to(cr.dtype)
    return _paged_rows(cc, page_table), _paged_rows(cr, page_table)


def mla_attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                        positions: torch.Tensor,
                        kv_cache: Optional[dict] = None, cache_pos=None,
                        page_table: Optional[torch.Tensor] = None,
                        page_size: int = 0):
    """MLA over ``x`` [B, S, D] at ``positions`` [B, S] with an optional
    latent cache (the four modes of the module doc).  Caches are updated
    in place; returns ``(y [B, S, D], kv_cache)``."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank

    # queries (low rank)
    q_lat = rmsnorm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps)
    q = (sharding.copy_to_model(q_lat) @ p["wq_b"]).reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = rope(q[..., dn:], positions, cfg.rope_theta)

    # compressed KV latent and the decoupled rope key (one broadcast head)
    kv = x @ p["wkv_a"]
    c_kv = rmsnorm(kv[..., :kvr], p["kv_a_norm"], cfg.norm_eps)   # [B, S, kvr]
    k_rope = rope(kv[..., kvr:][..., None, :], positions,
                  cfg.rope_theta)[..., 0, :]                      # [B, S, dr]

    if kv_cache is not None and page_table is not None:
        if S != 1:
            raise ValueError("paged MLA attention is decode-only (S == 1)")
        lat, kr = _write_paged(kv_cache, c_kv, k_rope, page_table, cache_pos,
                               page_size)
    elif kv_cache is not None:
        cc, cr = kv_cache["c_kv"], kv_cache["k_rope"]
        if isinstance(cache_pos, int):
            cc[:, cache_pos:cache_pos + S] = c_kv.to(cc.dtype)
            cr[:, cache_pos:cache_pos + S] = k_rope.to(cr.dtype)
            lat, kr = cc[:, :cache_pos + S], cr[:, :cache_pos + S]
        else:
            if S != 1:
                raise ValueError("per-sequence cache_pos is decode-only")
            b = torch.arange(B, device=x.device)
            cc[b, cache_pos.long()] = c_kv[:, 0].to(cc.dtype)
            cr[b, cache_pos.long()] = k_rope[:, 0].to(cr.dtype)
            lat, kr = cc, cr
    else:
        lat, kr = c_kv, k_rope
    lat, kr = sharding.copy_to_model(lat), sharding.copy_to_model(kr)
    T = lat.shape[1]

    # re-expand per-head keys and values from the latent (model dtype)
    kvb = (lat @ p["wkv_b"]).reshape(B, T, H, dn + dv)
    k_nope, v = kvb[..., :dn], kvb[..., dn:]

    # decode runs the fp32 products one sequence at a time (see
    # ``_per_sequence``); prefill batches them
    product = _per_sequence if S == 1 else torch.einsum
    scale = 1.0 / math.sqrt(dn + dr)
    scores = (product("bshd,bthd->bsht", q_nope.float(), k_nope.float())
              + product("bshd,btd->bsht", q_rope.float(), kr.float())) * scale
    kv_pos = torch.arange(T, device=x.device)
    mask = kv_pos[None, None, None, :] <= positions[:, :, None, None]
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    out = product("bsht,bthd->bshd", probs, v.float()).to(x.dtype)
    return sharding.all_reduce(out.reshape(B, S, H * dv) @ p["wo"]), kv_cache


def _per_sequence(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, a, b)`` over the leading (batch) axis one
    index at a time.  cuBLAS picks the kernel of a batched product by its
    batch count, and two kernels may sum in two orders: a decode step of
    8 sequences and one of 1 gave other bits for the same row on the
    H100.  Run one sequence at a time, each row's product has one shape
    whatever the batch, so a sequence decodes to the same bits alone, in
    the paged engine's batch or in the sequential ``Engine``."""
    return torch.cat([torch.einsum(equation, a[i:i + 1], b[i:i + 1])
                      for i in range(a.shape[0])])
