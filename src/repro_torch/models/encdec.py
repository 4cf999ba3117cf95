"""Whisper-style encoder-decoder (the port's counterpart of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the JAX package: the prefill takes
precomputed frame embeddings ``frames`` [B, S_enc, D]
(``data.pipeline.make_frames``).  The backbone is whole: a bidirectional
encoder with sinusoidal positions, a causal decoder with learned
positions and cross-attention over the encoder states, pre-LayerNorm with
bias, tanh-GELU MLPs, a head tied to the token embedding.

Parameters are per-layer dicts (``enc_layers.3.attn.wq``), the JAX
package's stacked ``enc_blocks`` / ``dec_blocks`` unstacked
(``convert``).  The cache keeps the reference's layout, ``{'self_kv':
{'k','v': [Ld, B, max_dec_len, H, hd]}, 'cross_kv': {'k','v': [Ld, B,
S_enc, H, hd]}}``, and is written in place.

Every attention runs a hand-written kernel (``kernels.ops``; on CPU
tensors its plain version):

  * encoder self-attention: ``flash_attention(causal=False)``, S = T =
    S_enc;
  * decoder self-attention in ``prefill`` and ``forward``:
    ``flash_attention(causal=True)``; cross-attention there:
    ``flash_attention(causal=False)``, S_dec queries over S_enc keys;
  * ``decode_step``: ``decode_attention`` over the layer's self cache
    (length ``pos + 1``) and over its cross K/V (length S_enc).

A layer's cache goes to the kernels as a strided ``[B, H, T, hd]`` view:
nothing is copied.  One prefill launches 3 x 24 flash kernels at
whisper-medium's depth, one decode step 2 x 24 ``decode_attention``.

Under a sharding plan ``distributed.sharding.param_specs`` and
``cache_specs`` place every leaf (q / k / v and their biases and the self
and cross caches by heads, ``wo`` and ``w2`` by rows, ``w1`` by columns,
the output biases, the LayerNorms and ``dec_pos`` whole, the embedding by
vocabulary where the model axis divides it).  Whisper trains under a
training plan (``cfg`` the rank's heads and MLP slice): every
LayerNorm's output enters the rank's heads or MLP slice through
``sharding.copy_to_model``, and so does the encoder's output at every
cross-attention's K / V; ``wo`` and ``w2`` end in one ``all_reduce``
each, their biases added once after it; the embedding's lookup and the
tied head run vocab-parallel where the embedding is split, the loss
without gathering the logits; under FSDP each block gathers its leaves
as it starts (a remat'd decoder block again when it is recomputed).
Under a serving plan ``prefill`` and ``decode_step`` run the rank's
heads of the encoder, the decoder's self-attention and its
cross-attention, with their caches (``cfg`` the rank's), and the MLPs'
slices; the odd vocabulary stays whole.  The sequential ``Engine`` takes
no plan for enc-dec, as the reference's does not.

The JAX reference rounds the softmax probabilities to v's dtype before
the P V product (``repro.models.layers._sdpa``); the kernels keep them in
fp32 (bf16 on the tensor cores), so bf16 runs differ from it there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import fsdp, sharding
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDraw, layernorm, lm_head, normal_
from repro_torch.models.transformer import (cross_entropy, remat_call,
                                            to_device, torch_dtype)
from repro_torch.utils import map_with_path


def _ln_params(d: int) -> dict:
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def _mha_params(gen: Optional[ParamDraw], d: int, h: int, hd: int) -> dict:
    """Bias on q, v and o; none on k (whisper's)."""
    return {"wq": normal_(gen, (d, h * hd)), "bq": torch.zeros(h * hd),
            "wk": normal_(gen, (d, h * hd)),
            "wv": normal_(gen, (d, h * hd)), "bv": torch.zeros(h * hd),
            "wo": normal_(gen, (h * hd, d)), "bo": torch.zeros(d)}


def _mlp2_params(gen: Optional[ParamDraw], d: int, f: int) -> dict:
    return {"w1": normal_(gen, (d, f)), "b1": torch.zeros(f),
            "w2": normal_(gen, (f, d)), "b2": torch.zeros(d)}


def _mlp2(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(sharding.copy_to_model(x) @ p["w1"] + p["b1"], approximate="tanh")
    return sharding.all_reduce(h @ p["w2"]) + p["b2"]


def _ln(x: torch.Tensor, p: dict) -> torch.Tensor:
    return layernorm(x, p["scale"], p["bias"])


def _heads(x: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], H, hd)


def _proj_q(p: dict, x: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    """The rank's query heads; ``x`` has passed the copy op."""
    return _heads(x @ p["wq"] + p["bq"], H, hd)


def _proj_kv(p: dict, x: torch.Tensor, H: int, hd: int) -> tuple:
    """The rank's key and value heads; ``x`` has passed the copy op."""
    return (_heads(x @ p["wk"], H, hd),
            _heads(x @ p["wv"] + p["bv"], H, hd))


def _flash(q, k, v, causal: bool) -> torch.Tensor:
    """[B, S, H, hd] queries over [B, T, H, hd] keys and values (views of
    activations or of a cache layer) -> [B, S, H * hd]."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    B, _, S, _ = out.shape
    return out.transpose(1, 2).reshape(B, S, -1)


def _decode(q, k, v, lengths) -> torch.Tensor:
    """One query [B, 1, H, hd] over the first ``lengths`` rows of a
    [B, T, H, hd] cache layer -> [B, 1, H * hd]."""
    out = ops.decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                               lengths)
    return out.reshape(out.shape[0], 1, -1)


def _out(p: dict, a: torch.Tensor) -> torch.Tensor:
    return sharding.all_reduce(a @ p["wo"]) + p["bo"]


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder positions [length, channels], float32 (numpy, as
    ``repro.models.encdec.sinusoids``: the same numbers)."""
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def param_tree(cfg: ModelConfig, gen: Optional[ParamDraw]) -> dict:
    """The parameter dict: fan-in scaled normals from ``gen`` (norm scales
    ones, biases zeros), or uninitialized tensors of the same shapes when
    ``gen`` is None (the ``meta`` specs).  Names follow
    ``repro.models.encdec.init_params`` with the stacks unstacked."""
    D, H, hd, F_, V = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size

    def enc_layer():
        return {"ln1": _ln_params(D), "attn": _mha_params(gen, D, H, hd),
                "ln2": _ln_params(D), "mlp": _mlp2_params(gen, D, F_)}

    def dec_layer():
        return {"ln1": _ln_params(D), "self_attn": _mha_params(gen, D, H, hd),
                "ln2": _ln_params(D), "cross_attn": _mha_params(gen, D, H, hd),
                "ln3": _ln_params(D), "mlp": _mlp2_params(gen, D, F_)}

    return {
        "embed": normal_(gen, (V, D), scale=0.02),       # tied head
        "dec_pos": normal_(gen, (cfg.max_dec_len, D), scale=0.01),
        "enc_layers": [enc_layer() for _ in range(cfg.n_layers)],
        "dec_layers": [dec_layer() for _ in range(cfg.dec_layers)],
        "enc_ln": _ln_params(D),
        "dec_ln": _ln_params(D),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                draw_on_device: bool = False, shard=None) -> dict:
    """Random parameters from a seeded ``ParamDraw`` (on the CPU unless
    ``draw_on_device``), each leaf cast and moved to ``device`` as it is
    drawn (as the other families' ``transformer.init_params``).
    ``shard(path, leaf)`` (a sharding plan's) then keeps each leaf's
    piece (the whole tree is drawn first: 3.1 GB for whisper-medium in
    fp32)."""
    dtype = torch_dtype(cfg.dtype)
    draw = ParamDraw(seed, device, dtype, on_device=draw_on_device)
    params = to_device(param_tree(cfg, draw), device, dtype)
    if shard is None:
        return params
    return map_with_path(shard, params)


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter dict as ``meta`` tensors (no storage, no draws)."""
    with torch.device("meta"):
        tree = param_tree(cfg, None)
    return to_device(tree, "meta", torch_dtype(cfg.dtype))


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zeroed caches in the model's dtype: the decoder's self-attention
    K/V over ``max_dec_len`` rows and the cross K/V over ``max_len``
    encoder rows (the frames' length)."""
    Ld, H, hd = cfg.dec_layers, cfg.n_heads, cfg.head_dim
    dtype = torch_dtype(cfg.dtype)

    def kv(rows):
        return {k: torch.zeros((Ld, batch, rows, H, hd), dtype=dtype,
                               device=device) for k in ("k", "v")}

    return {"self_kv": kv(cfg.max_dec_len), "cross_kv": kv(max_len)}


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, S_enc, D] in the model's dtype -> encoder states."""
    _, S, D = frames.shape
    H, hd = cfg.n_heads, cfg.head_dim
    pos = torch.from_numpy(sinusoids(S, D)).to(frames.device, frames.dtype)
    x = frames + pos[None]
    for i, bp in enumerate(params["enc_layers"]):
        bp = fsdp.gathered(bp, f"enc_layers.{i}")
        h = sharding.copy_to_model(_ln(x, bp["ln1"]))
        q = _proj_q(bp["attn"], h, H, hd)
        k, v = _proj_kv(bp["attn"], h, H, hd)
        x = x + _out(bp["attn"], _flash(q, k, v, causal=False))
        x = x + _mlp2(bp["mlp"], _ln(x, bp["ln2"]))
    return _ln(x, fsdp.gathered(params["enc_ln"], "enc_ln"))


def _check_dec_len(cfg: ModelConfig, n: int) -> None:
    if n < 1:
        raise ValueError(f"{cfg.name}: decoder position {n - 1} is negative")
    if n > cfg.max_dec_len:
        raise ValueError(f"{cfg.name}: decoder positions reach {n - 1}, past "
                         f"max_dec_len {cfg.max_dec_len}")


def _embed(params: dict, tokens: torch.Tensor, start: int) -> torch.Tensor:
    S = tokens.shape[1]
    embed = fsdp.gathered(params["embed"], "embed")
    pos = fsdp.gathered(params["dec_pos"], "dec_pos")
    return sharding.embed_lookup(embed, tokens) + pos[start:start + S][None]


def _head(params: dict, x: torch.Tensor, gather: bool = True) -> torch.Tensor:
    """Logits over the vocabulary from the tied embedding (the rank's
    vocabulary slice with ``gather=False`` under a vocab-parallel plan)."""
    x = _ln(x, fsdp.gathered(params["dec_ln"], "dec_ln"))
    return lm_head(x, {"embed": fsdp.gathered(params["embed"], "embed")},
                   True, gather)


def _dec_layer(bp: dict, x, cfg: ModelConfig, self_attn, cross_attn):
    """One decoder block: pre-LN self-attention, cross-attention and MLP,
    each with its residual.  ``self_attn(q, k, v)`` and ``cross_attn(p,
    q)`` (``p`` the block's cross-attention weights) attend, with or
    without a cache."""
    H, hd = cfg.n_heads, cfg.head_dim
    h = sharding.copy_to_model(_ln(x, bp["ln1"]))
    p = bp["self_attn"]
    q = _proj_q(p, h, H, hd)
    k, v = _proj_kv(p, h, H, hd)
    x = x + _out(p, self_attn(q, k, v))
    p = bp["cross_attn"]
    h = sharding.copy_to_model(_ln(x, bp["ln2"]))
    x = x + _out(p, cross_attn(p, _proj_q(p, h, H, hd)))
    return x + _mlp2(bp["mlp"], _ln(x, bp["ln3"]))


def decode_full(params: dict, cfg: ModelConfig, enc: torch.Tensor,
                tokens: torch.Tensor, remat: bool = False,
                gather: bool = True) -> torch.Tensor:
    """Teacher-forced decoder pass over ``tokens`` [B, S_dec] -> logits
    [B, S_dec, V] (the rank's vocabulary slice with ``gather=False``
    under a vocab-parallel plan).  ``remat`` recomputes each decoder
    layer in the backward (the reference checkpoints the decoder's scan
    body, not the encoder's)."""
    _check_dec_len(cfg, tokens.shape[1])
    H, hd = cfg.n_heads, cfg.head_dim
    x = _embed(params, tokens, 0)

    def cross(p, q):
        k, v = _proj_kv(p, sharding.copy_to_model(enc), H, hd)
        return _flash(q, k, v, causal=False)

    for i, bp in enumerate(params["dec_layers"]):
        x = remat_call(lambda h, i=i, bp=bp: _dec_layer(
            fsdp.gathered(bp, f"dec_layers.{i}"), h, cfg,
            lambda q, k, v: _flash(q, k, v, True), cross), x, remat)
    return _head(params, x, gather)


def forward(params: dict, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor, training: bool = False):
    """Encoder then teacher-forced decoder -> (logits [B, S_dec, V], aux =
    0).  ``training=False`` runs under ``no_grad``; ``training=True`` lets
    gradients flow (the encoder's and cross-attention's non-causal flash
    backward on a card) and, with ``cfg.remat``, recomputes each decoder
    layer in the backward."""
    with torch.set_grad_enabled(training and torch.is_grad_enabled()):
        logits = decode_full(params, cfg, encode(params, cfg, frames), tokens,
                             remat=training and cfg.remat)
    return logits, torch.zeros((), device=logits.device)


def loss_fn(params: dict, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor, labels: torch.Tensor,
            aux_weight: float = 0.0) -> torch.Tensor:
    """The reference's ``encdec.loss_fn``: the fp32 cross-entropy of the
    training forward's logits (whisper has no auxiliary loss); under a
    vocab-parallel plan from each rank's slice of them
    (``sharding.vocab_cross_entropy``)."""
    if not sharding.vocab_split():
        logits, _ = forward(params, cfg, frames, tokens, training=True)
        return cross_entropy(logits, labels)
    logits = decode_full(params, cfg, encode(params, cfg, frames), tokens,
                         remat=cfg.remat, gather=False)
    return sharding.vocab_cross_entropy(logits, labels)


def _cross_cache(cache: dict, B: int, T: int) -> dict:
    """The cache's cross K/V leaves, replaced by zeroed ones of ``T``
    encoder rows when they hold another length (the JAX prefill returns
    the cross K/V it computed, whatever the cache held)."""
    cross = cache["cross_kv"]
    if cross["k"].shape[1:3] != (B, T):
        shape = (cross["k"].shape[0], B, T) + tuple(cross["k"].shape[3:])
        cache["cross_kv"] = cross = {
            k: torch.zeros(shape, dtype=cross[k].dtype, device=cross[k].device)
            for k in ("k", "v")}
    return cross


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor, cache: dict):
    """Encode ``frames``, compute every decoder layer's cross K/V into the
    cache, then teacher-force the prompt ``tokens`` [B, S] (positions 0 ..
    S-1) into the self cache.  Returns (last-token logits [B, V], cache);
    the cache is written in place (its cross leaves replaced when they do
    not hold the frames' length)."""
    B, S = tokens.shape
    _check_dec_len(cfg, S)
    H, hd = cfg.n_heads, cfg.head_dim
    enc = encode(params, cfg, frames)
    T = enc.shape[1]
    cross = _cross_cache(cache, B, T)
    # every decoder layer's cross K/V right after the encoder and before
    # the token embedding: the JAX prefill's order (and its traced one)
    for layer, bp in enumerate(params["dec_layers"]):
        k, v = _proj_kv(bp["cross_attn"], enc, H, hd)
        cross["k"][layer].copy_(k)
        cross["v"][layer].copy_(v)
    x = _embed(params, tokens, 0)
    for layer, bp in enumerate(params["dec_layers"]):
        ck, cv = cache["self_kv"]["k"][layer], cache["self_kv"]["v"][layer]
        xk, xv = cross["k"][layer], cross["v"][layer]

        def self_attn(q, k, v):
            ck[:, :S] = k
            cv[:, :S] = v
            return _flash(q, ck[:, :S], cv[:, :S], causal=True)

        x = _dec_layer(bp, x, cfg, self_attn,
                       lambda p, q: _flash(q, xk, xv, causal=False))
    return _head(params, x[:, -1:])[:, 0], cache


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One decoder token per sequence: ``tokens`` [B, 1] at decoder
    position ``pos`` (an int, the whole batch at one position).  Its K/V
    land in row ``pos`` of the self cache.  Returns (logits [B, V],
    cache)."""
    pos = int(pos)
    _check_dec_len(cfg, pos + 1)
    B = tokens.shape[0]
    x = _embed(params, tokens, pos)
    cross = cache["cross_kv"]
    dev = x.device
    # lengths made on the device once per step, not per kernel call
    self_len = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
    cross_len = torch.full((B,), cross["k"].shape[2], dtype=torch.int32,
                           device=dev)
    for layer, bp in enumerate(params["dec_layers"]):
        ck, cv = cache["self_kv"]["k"][layer], cache["self_kv"]["v"][layer]
        xk, xv = cross["k"][layer], cross["v"][layer]

        def self_attn(q, k, v):
            ck[:, pos] = k[:, 0]
            cv[:, pos] = v[:, 0]
            return _decode(q, ck, cv, self_len)

        x = _dec_layer(bp, x, cfg, self_attn,
                       lambda p, q: _decode(q, xk, xv, cross_len))
    return _head(params, x)[:, 0], cache
