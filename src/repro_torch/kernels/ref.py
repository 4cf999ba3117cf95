"""Plain PyTorch versions of the attention and normalisation kernels.

Each function states what its CUDA kernel computes, with no tiling: the
kernel wrappers call these for tensors on the CPU, and ``chip_smoke.py``
holds every kernel against them on the card.  Layouts follow
``repro.kernels.ref`` so the tests compare like with like.
"""

from __future__ import annotations

import math

import torch

# finite mask value (jnp.finfo(float32).min): exp(m_prev - m_new) stays
# NaN-free even when a whole row of scores is masked
NEG_INF = torch.finfo(torch.float32).min


def flash_attention_ref(q, k, v, causal: bool = True, softcap: float = 0.0):
    """q: [B, H, S, d]; k, v: [B, KV, T, d] (GQA: H multiple of KV), T >= S
    when causal.  The causal mask is aligned bottom-right
    (``col <= row + T - S``), so the last query row sees every key.
    Returns [B, H, S, d] in ``q.dtype``."""
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, S, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(d)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None] + (T - S))
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    return out.reshape(B, H, S, d).to(q.dtype)


def decode_attention_ref(q, k, v, length):
    """One-token attention against a KV cache.

    q: [B, H, d]; k, v: [B, KV, T, d]; length: int or [B] — number of
    valid cache positions.  Returns [B, H, d]."""
    B, H, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, d).float()
    scores = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) / math.sqrt(d)
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    valid = torch.arange(T, device=q.device)[None, :] < length
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v.float())
    return out.reshape(B, H, d).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths,
                               k_scales=None, v_scales=None):
    """One-token attention against a block-paged KV arena.

    q: [B, H, d]; k_pages, v_pages: [P, ps, KV, d] — one shared arena in
    storage layout (page 0 is the runtime's null page); page_table:
    [B, NB] int physical page per logical block; lengths: int or [B].
    With ``k_scales``/``v_scales`` ([P, ps, KV] float32) the arena is int8
    and each row dequantizes as ``row * scale``.  Returns [B, H, d].
    """
    B, H, d = q.shape
    P, ps, KV, _ = k_pages.shape
    NB = page_table.shape[1]
    if k_scales is not None:
        k_pages = k_pages.float() * k_scales.float()[..., None]
        v_pages = v_pages.float() * v_scales.float()[..., None]
    pt = page_table.long()
    k = k_pages[pt].reshape(B, NB * ps, KV, d).transpose(1, 2)
    v = v_pages[pt].reshape(B, NB * ps, KV, d).transpose(1, 2)
    return decode_attention_ref(q, k, v, lengths)


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """RMSNorm with fp32 statistics; the scale is promoted to fp32 too.
    x: [..., d]; scale: [d].  Returns x's shape and dtype."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)
