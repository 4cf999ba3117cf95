"""Core transformer layers of the dense family, as functions over tensors.

Every layer is ``f(params, x, ...) -> y`` over a dict of tensors, as in
``repro.models.layers``.  Weight matrices keep the JAX package's
``[in, out]`` layout, so a projection is ``x @ w``.  Attention runs the
hand-written kernels through ``kernels.ops`` (CUDA tensors) or their plain
versions (CPU tensors), and so does every RMSNorm.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import quant
from repro_torch.models.adapters import lora_delta
from repro_torch.models.config import ModelConfig


class ParamDraw:
    """Where random parameters come from: float32 normals drawn on the CPU
    from one seeded ``torch.Generator`` (so a seed gives the same weights
    on every device), each cast to ``dtype`` and moved to ``device`` as
    soon as it is drawn, so host memory holds one leaf at a time.  The
    scale is applied in place: the draw's peak is the float32 leaf and its
    cast (deepseek-v3's [256, 7168, 2048] expert leaves are 15 GB in
    float32 each).  ``on_device`` draws on ``device`` from a generator of
    its own: the same weights for a seed on one kind of device only."""

    def __init__(self, seed: int, device="cpu", dtype=torch.float32,
                 on_device: bool = False):
        draw_on = torch.device(device) if on_device else torch.device("cpu")
        self.gen = torch.Generator(device=draw_on).manual_seed(seed)
        self.draw_on = draw_on
        self.device, self.dtype = device, dtype

    def normal(self, shape: tuple, scale: float) -> torch.Tensor:
        t = torch.randn(shape, generator=self.gen, device=self.draw_on)
        return t.mul_(scale).to(device=self.device, dtype=self.dtype)


@dataclasses.dataclass
class PendingDraw:
    """A leaf not drawn yet: its shape, scale and place in the draw order."""
    shape: tuple
    scale: float
    index: int


class LazyDraw:
    """Records the draws a parameter tree makes instead of making them, so
    a sharded init can draw each full leaf in the one-device order and
    keep only a slice of it."""

    def __init__(self):
        self.n = 0

    def normal(self, shape: tuple, scale: float) -> PendingDraw:
        self.n += 1
        return PendingDraw(tuple(shape), scale, self.n)


def normal_(draw: Optional[ParamDraw], shape, scale: Optional[float] = None):
    """A normal leaf from ``draw``, fan-in scaled (1/sqrt(shape[0])) unless
    ``scale`` is given.  With ``draw=None`` an uninitialized tensor of the
    shape on the default device (the ``meta`` parameter specs)."""
    shape = tuple(int(s) for s in shape)
    if draw is None:
        return torch.empty(shape)
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    return draw.normal(shape, scale)


# ---------------------------------------------------------------------------
# normalization / rotary position embedding
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            residual: Optional[torch.Tensor] = None):
    """RMSNorm with fp32 statistics; the scale is promoted to fp32 too.
    The ``rmsnorm`` kernel on a CUDA tensor, its plain version on the CPU.
    With ``residual`` it returns ``(norm(x + residual), x + residual)``,
    the add fused into the kernel."""
    return ops.rmsnorm(x, scale, eps, residual=residual)


def split_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6, width: Optional[int] = None) -> torch.Tensor:
    """RMSNorm of a row a sharding plan cuts over the ranks (the recurrent
    mixers' inner norms): ``x`` and ``scale`` hold this rank's slice of
    every row, and the mean of squares is the whole row's, the slices'
    sums of squares added over the ranks (one ``all_reduce`` of a fp32
    ``[rows]`` buffer) between the split-row form's two launches.  A
    slice normalised alone would take its own mean.  Training, its
    backward sums each row's dot over the ranks the same way.  ``width``
    is the whole row's (by default ``tp`` slices as wide as this one; the
    xLSTM's heads may split unevenly).  Without a plan the one-launch
    :func:`rmsnorm`."""
    plan = sharding.current_plan()
    if plan is None:
        return ops.rmsnorm(x, scale, eps)
    return ops.rmsnorm_split(x, scale, eps,
                             width or x.shape[-1] * plan.tp,
                             sharding.rank_sum(plan))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with bias (whisper): fp32 statistics, the population
    variance, then ``* scale + bias`` and a cast back to ``x``'s dtype, as
    ``repro.models.layers.layernorm``.  Plain PyTorch: the JAX package has
    no kernel for it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Apply RoPE. x: [..., S, H, hd]; positions: [..., S] (broadcastable)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=x.device)
                      * (math.log(theta) / half))
    angles = positions[..., :, None].float() * freqs          # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _sdpa(q, k, v, mask, softcap: float = 0.0):
    """Grouped scaled-dot-product attention (plain PyTorch).

    q: [B, S, KV, G, hd]; k, v: [B, T, KV, hd]; mask broadcastable to
    [B, S, 1, 1, T] (True = attend).  Scores in fp32; the probabilities
    are rounded to v's dtype before the PV product, as the JAX path does.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgd,btkd->bskgt", q.float(), k.float()) * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bskgt,btkd->bskgd", probs.float(), v.float())
    return out.to(v.dtype)


def init_attn_params(gen: Optional[ParamDraw], cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.fused_qkv:
        p = {"wqkv": normal_(gen, (D, (H + 2 * KV) * hd)),
             "wo": normal_(gen, (H * hd, D))}
    else:
        p = {"wq": normal_(gen, (D, H * hd)), "wk": normal_(gen, (D, KV * hd)),
             "wv": normal_(gen, (D, KV * hd)), "wo": normal_(gen, (H * hd, D))}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H * hd)
        p["bk"] = torch.zeros(KV * hd)
        p["bv"] = torch.zeros(KV * hd)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd)
        p["k_norm"] = torch.ones(hd)
    return p


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, kv_cache: Optional[dict] = None,
                    cache_pos=None, causal: bool = True,
                    page_table: Optional[torch.Tensor] = None,
                    page_size: int = 0, adapters: Optional[dict] = None,
                    adapter_ids: Optional[torch.Tensor] = None):
    """GQA/MQA attention with an optional KV cache.

    Three branches, as in ``repro.models.layers.attention_block``:

    * no cache: causal attention over ``x`` itself (the flash kernel);
    * dense cache ``{'k','v': [B, T, KV, hd]}``: K/V land in place at
      ``cache_pos`` (an int: rows ``cache_pos ..``; a ``[B]`` tensor:
      each sequence at its own offset, decode only).  One query token
      (S == 1, decode) goes to the ``decode_attention`` kernel over the
      first ``cache_pos + 1`` rows, reading the cache in its storage
      layout; longer prefills and suffix prefills go to the flash kernel
      over the first ``cache_pos + S`` rows with the bottom-right causal
      mask;
    * paged (``page_table`` given, decode only): the cache leaves are one
      arena ``[P, page_size, KV, hd]``; this token's K/V (quantized on
      append for an int8 arena) are written into its page and the paged
      decode kernel attends over the pages the table maps.  The kernel
      has no logit softcap: a config with one raises here, as the dense
      decode branch does.

    With ``adapters`` (one layer's slice of an adapter bank) each targeted
    projection adds its per-sequence low-rank delta, bank row
    ``adapter_ids[b]``: q/k/v before the bias and reshape, ``wo`` after
    the output projection, as in the JAX package.

    ``cfg.fused_qkv``: one ``wqkv`` product split into q, k and v, as in
    the JAX package.  Under a sharding plan ``cfg`` is the rank's local
    configuration (its heads) and the output projection's partial sums
    meet the other ranks' in one ``all_reduce``.  For training, the
    input enters the rank's heads through ``sharding.copy_to_model`` (its
    gradient summed over the ranks), and so do the q / k norm scales;
    K/V projections every rank holds whole (one KV head) take their
    input as it is and enter the rank's attention after the rope; a KV
    head some but not all ranks share sums its projections' gradients
    over those ranks (``sharding.sum_grad_kv``).

    Under a ``prefer_seq`` plan the dense cache holds this rank's slice of
    the sequence axis for every KV head (:func:`_seq_split_attention`).
    A rank that holds no head (heads split unevenly) runs the same
    products on empty tensors, so its collectives match the other
    ranks', and launches no attention kernel.

    Caches are updated in place and the block returns ``(y, kv_cache)``.
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV if KV else 0
    kv_whole = sharding.kv_whole()
    xq = sharding.copy_to_model(x)
    xkv = x if kv_whole else xq
    wk, wv = (sharding.sum_grad_kv(p[n]) for n in ("wk", "wv")) \
        if "wk" in p else (None, None)
    if cfg.fused_qkv:
        if adapters is not None:
            raise NotImplementedError(
                "adapter gather targets the unfused wq/wk/wv/wo projections")
        q, k, v = (xq @ p["wqkv"]).split([H * hd, KV * hd, KV * hd], dim=-1)
    else:
        q, k, v = xq @ p["wq"], xkv @ wk, xkv @ wv
    if adapters is not None:
        if "wq" in adapters:
            q = q + lora_delta(x, adapters["wq"], adapter_ids)
        if "wk" in adapters:
            k = k + lora_delta(x, adapters["wk"], adapter_ids)
        if "wv" in adapters:
            v = v + lora_delta(x, adapters["wv"], adapter_ids)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + sharding.sum_grad_kv(p["bk"])
        v = v + sharding.sum_grad_kv(p["bv"])
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, sharding.copy_to_model(p["q_norm"]), cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"] if kv_whole
                    else sharding.copy_to_model(p["k_norm"]), cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kv_whole:
        k, v = sharding.copy_to_model(k), sharding.copy_to_model(v)
    softcap = cfg.attn_logit_softcap
    seq = sharding.seq_shard()

    if H == 0 and seq is None:
        # a rank holding no head (an uneven split) launches no attention
        # kernel (a zero-sized grid); its empty output adds zeros below,
        # and in training its empty K/V join it, so that a step takes
        # their (empty) gradients
        out = q + (k.sum() + v.sum()).to(q.dtype) \
            if torch.is_grad_enabled() else q
    elif kv_cache is not None and seq is not None:
        if page_table is not None:
            raise NotImplementedError(
                "a paged arena is not split by sequence (prefer_seq)")
        out = _seq_split_attention(q, k, v, kv_cache, cache_pos, seq, softcap)
    elif kv_cache is not None and page_table is not None:
        if S != 1:
            raise ValueError("paged attention is decode-only (S == 1)")
        if softcap > 0:
            raise NotImplementedError(
                "paged_decode_attention has no logit softcap")
        ck, cv = kv_cache["k"], kv_cache["v"]
        pages = page_table[torch.arange(B, device=x.device),
                           (cache_pos // page_size).long()].long()
        off = (cache_pos % page_size).long()
        cks = cvs = None
        # In-place writes into the shared arena: steps run in order on one
        # stream, so the kernel launched below reads this token's rows and
        # no step ever copies the whole arena.
        if quant.is_quantized_cache(kv_cache):
            qk, sk = quant.quantize_rows(k[:, 0])           # [B,KV,hd], [B,KV]
            qv, sv = quant.quantize_rows(v[:, 0])
            cks, cvs = kv_cache["k_scale"], kv_cache["v_scale"]
            ck[pages, off] = qk
            cv[pages, off] = qv
            cks[pages, off] = sk
            cvs[pages, off] = sv
        else:
            ck[pages, off] = k[:, 0].to(ck.dtype)
            cv[pages, off] = v[:, 0].to(cv.dtype)
        out = ops.paged_decode_attention(q[:, 0], ck, cv, page_table,
                                         (cache_pos + 1).to(torch.int32),
                                         k_scales=cks, v_scales=cvs)[:, None]
    elif kv_cache is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        if isinstance(cache_pos, int):
            # write in place, then attend over the filled rows
            ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
            cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
        else:
            if S != 1:
                raise ValueError("per-sequence cache_pos is decode-only")
            b = torch.arange(B, device=x.device)
            ck[b, cache_pos.long()] = k[:, 0].to(ck.dtype)
            cv[b, cache_pos.long()] = v[:, 0].to(cv.dtype)
        if S == 1:
            if softcap > 0:
                raise NotImplementedError(
                    "decode_attention has no logit softcap")
            out = ops.decode_attention(q[:, 0], ck.transpose(1, 2),
                                       cv.transpose(1, 2),
                                       cache_pos + 1)[:, None]
        else:
            T = cache_pos + S
            out = ops.flash_attention(
                q.transpose(1, 2), ck[:, :T].transpose(1, 2),
                cv[:, :T].transpose(1, 2), causal=True,
                softcap=softcap).transpose(1, 2)
    elif causal:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True,
                                  softcap=softcap).transpose(1, 2)
    else:
        mask = torch.ones((1, 1, 1, 1, S), dtype=torch.bool, device=x.device)
        out = _sdpa(q.reshape(B, S, KV, G, hd), k, v, mask, softcap)

    out = out.reshape(B, S, H * hd)
    y = out @ p["wo"]
    if adapters is not None and "wo" in adapters:
        y = y + lora_delta(out, adapters["wo"], adapter_ids)
    return sharding.all_reduce(y), kv_cache


def _select_heads(x: torch.Tensor, at: tuple) -> torch.Tensor:
    """``x [tp, ..., n, hd]`` (every rank's heads, padded to ``n``) as
    ``[..., len(ranks), hd]``: head ``heads[i]`` of rank ``ranks[i]``,
    ``at = (ranks, heads)`` (:func:`_q_index`, :func:`_kv_index`)."""
    ranks, heads = at
    return x[ranks, ..., heads, :].movedim(0, -2)


@functools.lru_cache(maxsize=None)
def _kv_index(split, device: str) -> tuple:
    """Each KV head's place among the ranks' heads: ``(ranks, heads)``,
    in the first rank that holds it."""
    ranks = [split.holders(j)[0] for j in range(split.n_kv)]
    heads = [j - split.kv[r][0] for j, r in enumerate(ranks)]
    return (torch.tensor(ranks, dtype=torch.long, device=device),
            torch.tensor(heads, dtype=torch.long, device=device))


@functools.lru_cache(maxsize=None)
def _q_index(split, device: str) -> tuple:
    """Each query head's place among the ranks' heads: ``(ranks,
    heads)``."""
    at = [(r, i) for r, (a, b) in enumerate(split.q) for i in range(b - a)]
    return tuple(torch.tensor(c, dtype=torch.long, device=device)
                 for c in zip(*at))


def _pad_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x [..., h, hd]`` with zero heads appended up to ``n``."""
    h = x.shape[-2]
    if h == n:
        return x
    pad = x.new_zeros(tuple(x.shape[:-2]) + (n - h, x.shape[-1]))
    return torch.cat([x, pad], dim=-2)


def _seq_split_attention(q, k, v, kv_cache: dict, cache_pos, seq,
                         softcap: float) -> torch.Tensor:
    """Attention over a cache whose sequence axis is split over the model
    ranks (``prefer_seq``; rank ``r`` holds positions ``[r T_r, (r + 1)
    T_r)`` of all ``n_kv`` KV heads; ``q`` [B, S, H_r, hd], ``k`` / ``v``
    [B, S, KV_r, hd] are this rank's heads).  Returns the rank's heads'
    output [B, S, H_r, hd].

    * A prefill from position 0 attends over its own k, v (the flash
      kernel, as without the split), then gathers every rank's K/V rows
      (one ``all_gather``) and writes this rank's positions of them.
    * A decode step (S == 1) gathers q and the new token's K/V rows from
      every rank (one ``all_gather``); the rank that owns the position
      writes the row.  Every rank runs ``decode_attention_slice`` over its
      rows for all H query heads, the ranks' ``(o, lse)`` are gathered (one
      ``all_gather``, fp32) and ``decode_merge_ranks`` combines them in
      rank order; the rank keeps its own heads' rows.
    Each rank's heads go into a gather padded with zero heads to the
    most any rank holds (a gather takes one size from every rank; where
    the heads split evenly there is nothing to pad), and the heads are
    picked out of it by index (:func:`_q_index`, :func:`_kv_index`).
    A suffix or chunked prefill raises (ROADMAP Queue 1, item 10)."""
    B, S, Hr, hd = q.shape
    split = seq.split
    Hm = max(b - a for a, b in split.q)
    KVm = max(b - a for a, b in split.kv)
    ck, cv = kv_cache["k"], kv_cache["v"]             # [B, T_r, KV, hd]
    Tr, r0 = ck.shape[1], seq.rank * ck.shape[1]
    if S > 1:
        if not (isinstance(cache_pos, int) and cache_pos == 0):
            raise NotImplementedError(
                "a suffix or chunked prefill over a sequence-sharded cache "
                "(prefer_seq): ROADMAP Queue 1, item 10")
        if S > Tr * seq.tp:
            raise ValueError(f"a prompt of {S} tokens overflows a cache of "
                             f"{Tr * seq.tp} rows")
        out = q if Hr == 0 else ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, softcap=softcap).transpose(1, 2)
        kv = _select_heads(sharding.gather_model(
            _pad_heads(torch.cat([k, v], dim=-1), KVm)),
            _kv_index(split, str(q.device)))
        n = min(max(S - r0, 0), Tr)
        ck[:, :n] = kv[:, r0:r0 + n, :, :hd].to(ck.dtype)
        cv[:, :n] = kv[:, r0:r0 + n, :, hd:].to(cv.dtype)
        return out
    if softcap > 0:
        raise NotImplementedError("decode_attention has no logit softcap")
    H = split.n_heads
    rows = sharding.gather_model(torch.cat(
        [_pad_heads(t[:, 0], n).reshape(B, n * hd)
         for t, n in ((q, Hm), (k, KVm), (v, KVm))],
        dim=-1))                                      # [tp, B, (Hm + 2 KVm) hd]
    qs = rows[..., :Hm * hd].reshape(seq.tp, B, Hm, hd)
    q_all = _select_heads(qs, _q_index(split, str(q.device))).contiguous()
    kv_at = _kv_index(split, str(q.device))
    k_new = _select_heads(rows[..., Hm * hd:(Hm + KVm) * hd]
                          .reshape(seq.tp, B, KVm, hd), kv_at)
    v_new = _select_heads(rows[..., (Hm + KVm) * hd:]
                          .reshape(seq.tp, B, KVm, hd), kv_at)
    pos = torch.as_tensor(cache_pos, dtype=torch.int64, device=q.device)
    pos = pos.reshape(-1).expand(B)
    local = pos - r0
    mine = ((local >= 0) & (local < Tr))[:, None, None]
    b, at = torch.arange(B, device=q.device), local.clamp(0, Tr - 1)
    ck[b, at] = torch.where(mine, k_new.to(ck.dtype), ck[b, at])
    cv[b, at] = torch.where(mine, v_new.to(cv.dtype), cv[b, at])
    lengths = (pos + 1 - r0).clamp(0, Tr).to(torch.int32)
    o, lse = ops.decode_attention_slice(q_all, ck.transpose(1, 2),
                                        cv.transpose(1, 2), lengths)
    parts = sharding.gather_model(torch.cat([o.reshape(B, H * hd), lse],
                                            dim=-1))  # [tp, B, H (hd + 1)]
    merged = ops.decode_merge_ranks(
        parts[..., :H * hd].reshape(seq.tp, B, H, hd),
        parts[..., H * hd:].contiguous(), q.dtype)
    first = split.q[seq.rank][0]
    return merged[:, first:first + Hr][:, None]


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp_params(gen: Optional[ParamDraw], d_model: int, d_ff: int,
                    fused: bool = False) -> dict:
    if fused:
        return {"w_gu": normal_(gen, (d_model, 2 * d_ff)),
                "w_down": normal_(gen, (d_ff, d_model))}
    return {"w_gate": normal_(gen, (d_model, d_ff)),
            "w_up": normal_(gen, (d_model, d_ff)),
            "w_down": normal_(gen, (d_ff, d_model))}


def mlp_partial(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The gated MLP over the width its weights hold: under a sharding
    plan the rank's slice of ``d_ff`` (``w_gu`` holds its gate and up
    slices side by side), so the result is this rank's partial sum of
    the down projection (the whole product on one device)."""
    if "w_gu" in p:
        g, u = (x @ p["w_gu"]).chunk(2, dim=-1)
    else:
        g, u = x @ p["w_gate"], x @ p["w_up"]
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (a * u) @ p["w_down"]


def mlp_block(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The gated MLP; under a sharding plan the ranks' partial sums
    (:func:`mlp_partial`) meet in one ``all_reduce``, and the input's
    gradient is summed over them (``copy_to_model``)."""
    return sharding.all_reduce(mlp_partial(p, sharding.copy_to_model(x), act))


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------

def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 scale_by_dim: bool = False) -> torch.Tensor:
    """Embedding rows (a vocab-parallel lookup under a sharding plan)."""
    x = sharding.embed_lookup(embed, tokens)
    if scale_by_dim:
        x = x * math.sqrt(embed.shape[1])
    return x


def lm_head(x: torch.Tensor, params: dict, tied: bool,
            gather: bool = True) -> torch.Tensor:
    """Logits over the vocabulary (gathered from the ranks' slices under
    a vocab-parallel plan; ``gather=False``: the rank's slice, for
    ``sharding.vocab_cross_entropy``)."""
    w = params["embed"].T if tied else params["lm_head"]
    if not sharding.vocab_split():
        return x @ w
    logits = sharding.copy_to_model(x) @ w
    return sharding.gather_vocab(logits) if gather else logits
