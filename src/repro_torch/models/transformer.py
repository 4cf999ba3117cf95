"""Decoder language models: parameters, caches and entry points.

The JAX package scans one block body over parameters stacked ``[L, ...]``;
here the parameters are a list of per-layer dicts and the scan is a Python
loop.  Caches keep the JAX layout with the layer axis first, and each
layer works on its ``cache[key][l]`` view in place.

Four families are ported: the dense GQA decoder (``layers``), moe (the
same blocks with a top-k expert layer, ``moe``, in place of the MLP),
zamba, the Mamba2 hybrid (``mamba``: one dict per Mamba2 block;
``shared_attn``: ONE attention + MLP block applied after every
``attn_every`` Mamba2 blocks), and xlstm (``mlstm``: one dict per mLSTM
block, in the reference's unit-major order; ``slstm``: one per unit of
``slstm_every - 1`` mLSTM blocks and one sLSTM block).  A zamba cache is
``{'mamba': {'h', 'conv'}, 'attn_kv': {'k', 'v'}}``, an xlstm cache
``{'mlstm': {'C', 'n', 'm', 'conv'}, 'slstm': {'c', 'n', 'h', 'm'}}``.
With ``cfg.use_mla`` (deepseek-v3) a dense or moe block's attention is
MLA (``models.mla``) and its cache the latent ``{'c_kv', 'k_rope'}``.

Entry points:
  forward(params, cfg, tokens, training=False)        -> (logits, aux)
  loss_fn(params, cfg, tokens, labels)                -> scalar loss
  prefill(params, cfg, tokens, cache)                 -> (last logits, cache)
  prefill_from(params, cfg, tokens, cache, offset)    -> (last logits, cache)
  decode_step(params, cfg, cache, tokens, pos)        -> (logits, cache)
  decode_step_paged(params, cfg, cache, tokens, pos, page_table, page_size)
  (prefill_from and decode_step_paged: dense and moe families only)
  init_params(cfg, seed, device)                      -> params
  param_specs(cfg)                                    -> params on ``meta``
  make_cache / make_paged_cache                       -> cache dict

``forward(training=True)`` is the training forward: gradients flow
(through the kernels' backward kernels on a card), each block the
reference checkpoints is recomputed in the backward when ``cfg.remat``
(``torch.utils.checkpoint``), and ``aux`` sums the moe blocks' load-
balancing losses.  The serving entry points run under ``no_grad``.
Under a training plan (``distributed.fsdp``) every family gathers each
block's leaves as the block starts (inside a remat'd block, so its
recomputation gathers again; zamba's shared block once per forward,
its uses' gradients summed before the one scatter), the embedding and
the head theirs where they are read, and ``loss_fn`` takes a
vocab-parallel head's loss without gathering its logits.
"""

from __future__ import annotations

import contextvars
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import fsdp, sharding
from repro_torch.models import mla, moe, quant, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (LazyDraw, ParamDraw, PendingDraw,
                                       attention_block, embed_tokens,
                                       init_attn_params, init_mlp_params,
                                       lm_head, mlp_block, mlp_partial,
                                       normal_, rmsnorm)
from repro_torch.utils import map_with_path, named_leaves

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name_or_dtype) -> torch.dtype:
    """``'bfloat16'`` (a config's dtype string) or a torch dtype -> dtype."""
    if isinstance(name_or_dtype, torch.dtype):
        return name_or_dtype
    return _DTYPES[name_or_dtype]


def check_family(cfg: ModelConfig) -> None:
    """Raise for the families this port does not serve yet, and for an
    xlstm depth that is not a whole number of units (an xlstm without
    sLSTM blocks, ``slstm_every`` 0, is not ported).  Enc-dec (whisper)
    lives in ``models.encdec``."""
    ported = (cfg.family in ("dense", "moe", "zamba", "xlstm", "encdec")
              and (cfg.family == "encdec") == cfg.is_encdec
              and not (cfg.use_mla
                       and cfg.family in ("zamba", "xlstm", "encdec"))
              and (cfg.family == "moe") == bool(cfg.n_experts))
    if not ported:
        raise NotImplementedError(
            f"{cfg.name}: the dense and moe families (GQA or MLA attention), "
            "zamba, xLSTM and enc-dec (whisper) are ported; MLA in a zamba, "
            "xLSTM or enc-dec block, and experts outside the moe family, "
            "are not yet")
    if cfg.family == "xlstm" and (
            not cfg.slstm_every or cfg.n_layers < cfg.slstm_every
            or cfg.n_layers % cfg.slstm_every):
        raise ValueError(
            f"{cfg.name}: {cfg.n_layers} layers are not a whole number of "
            f"units of {cfg.slstm_every} blocks (slstm_every)")


def _decoder_only(cfg: ModelConfig) -> None:
    check_family(cfg)
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: enc-dec runs through models.encdec "
                         "(registry.Model dispatches to it)")


def n_units(cfg: ModelConfig) -> int:
    """zamba: the units of ``attn_every`` Mamba2 blocks, each followed by
    the shared attention block."""
    return cfg.n_layers // cfg.attn_every


def xlstm_units(cfg: ModelConfig) -> tuple:
    """xlstm: (units, mLSTM blocks per unit).  A unit is ``slstm_every -
    1`` mLSTM blocks and one sLSTM block."""
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def _check_positional(cfg: ModelConfig, what: str) -> None:
    if not supports_paged_kv(cfg):
        raise ValueError(
            f"{cfg.name}: {cfg.family!r} family has no {what} (recurrent "
            "state is not position-addressable)")


def supports_paged_kv(cfg: ModelConfig) -> bool:
    """Block-paged KV applies to caches that grow with the sequence."""
    return cfg.family in ("dense", "moe")


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def _param_tree(cfg: ModelConfig, gen: Optional[ParamDraw]) -> dict:
    """The parameter dict: normals from ``gen`` (fan-in scaled; norms
    ones, biases zeros, float32 until :func:`to_device`), or uninitialized
    tensors of the same shapes when ``gen`` is None (see
    :func:`param_specs`).  A moe block has ``moe`` in place of ``mlp``,
    an MLA block MLA's projections as ``attn``."""
    V, D = cfg.vocab_size, cfg.d_model

    def attn_mlp_block():
        p = {"attn_norm": torch.ones(D), "mlp_norm": torch.ones(D),
             "attn": (mla.make_mla_params(gen, cfg) if cfg.use_mla
                      else init_attn_params(gen, cfg))}
        if cfg.n_experts:
            p["moe"] = moe.make_moe_params(gen, cfg)
        else:
            p["mlp"] = init_mlp_params(gen, D, cfg.d_ff, fused=cfg.fused_glu)
        return p

    params: dict = {"embed": normal_(gen, (V, D), scale=0.02)}
    if cfg.family == "xlstm":
        units, m_per = xlstm_units(cfg)
        params["mlstm"] = [{"norm": torch.ones(D),
                            "mixer": ssm.make_mlstm_params(gen, cfg)}
                           for _ in range(units * m_per)]
        params["slstm"] = [{"norm": torch.ones(D), "mlp_norm": torch.ones(D),
                            "mixer": ssm.make_slstm_params(gen, cfg)}
                           for _ in range(units)]
    elif cfg.family == "zamba":
        params["mamba"] = [{"norm": torch.ones(D),
                            "mixer": ssm.init_mamba2_params(gen, cfg)}
                           for _ in range(cfg.n_layers)]
        params["shared_attn"] = attn_mlp_block()
    else:
        params["layers"] = [attn_mlp_block() for _ in range(cfg.n_layers)]
    params["final_norm"] = torch.ones(D)
    if not cfg.tied_embeddings:
        params["lm_head"] = normal_(gen, (D, V), scale=0.02)
    return params


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                draw_on_device: bool = False, shard=None) -> dict:
    """Random parameters drawn from a seeded CPU ``torch.Generator`` (a
    fan-in scaled normal; norms ones, biases zeros): the same seed gives
    the same weights on every device.  Each leaf is cast and moved to
    ``device`` as soon as it is drawn, so host memory holds one leaf at a
    time (llama2-13b would need 52 GB for its whole float32 tree).
    ``draw_on_device``: see ``layers.ParamDraw``.

    ``shard(path, leaf)`` (a sharding plan's) keeps a slice of each full
    leaf: the leaves are drawn in the one-device order and each is cut
    as soon as it is drawn, into a copy of its own, so every rank holds
    the weights of the same seed at one leaf's transient cost (the full
    draw of one expert leaf, 3.76 GB for deepseek-v3's [256, 7168,
    2048] in bf16, freed before the next is drawn)."""
    _decoder_only(cfg)
    dtype = torch_dtype(cfg.dtype)
    draw = ParamDraw(seed, device, dtype, on_device=draw_on_device)
    if shard is None:
        return to_device(_param_tree(cfg, draw), device, dtype)
    with torch.device("cpu"):
        lazy = _param_tree(cfg, LazyDraw())
    drawn = {}
    for path, leaf in sorted(((p, t) for p, t in named_leaves(lazy)
                              if isinstance(t, PendingDraw)),
                             key=lambda pt: pt[1].index):
        drawn[path] = shard(path, draw.normal(leaf.shape, leaf.scale))
    return map_with_path(
        lambda path, t: drawn[path] if path in drawn
        else shard(path, t.to(device=device, dtype=dtype)), lazy)


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter dict as ``meta`` tensors: every leaf's shape and dtype,
    no storage and no random draws (the counterpart of the JAX package's
    ``init_params(abstract=True)``).  Tracing, ``assemble`` and the LoRA
    helpers read the model's structure from it."""
    _decoder_only(cfg)
    with torch.device("meta"):
        tree = _param_tree(cfg, None)
    return to_device(tree, "meta", torch_dtype(cfg.dtype))


def to_device(tree, device, dtype: Optional[torch.dtype] = None):
    """Move a nested dict/list of tensors to ``device`` (and ``dtype``)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Dense per-sequence cache.  Dense and moe families: ``{'k','v': [L,
    batch, max_len, KV, hd]}``, or with MLA ``{'c_kv': [L, batch, max_len,
    kvr], 'k_rope': [L, batch, max_len, dr]}``.  zamba: ``{'mamba': {'h':
    [L, batch, H, dh, ds] fp32, 'conv': [L, batch, W-1, conv_ch]},
    'attn_kv': {'k','v': [n_units, batch, max_len, KV, hd]}}``.  Axis 1 of
    every leaf is the batch (slot) axis.  xlstm: ``{'mlstm': {'C': [n_m,
    batch, H, dh, dh], 'n', 'm' fp32 ('m' filled with ``EMPTY_M``),
    'conv'}, 'slstm': {'c', 'n', 'h', 'm': [units, batch, H, dh] fp32
    zeros}}``; ``max_len`` is unused (the state does not grow)."""
    _decoder_only(cfg)
    dt = torch_dtype(cfg.dtype)
    L = cfg.n_layers
    if cfg.family == "xlstm":
        units, m_per = xlstm_units(cfg)
        cache = {"mlstm": {
            k: torch.zeros((units * m_per,) + s, device=device,
                           dtype=dt if k == "conv" else torch.float32)
            for k, s in ssm.mlstm_state_shape(cfg, batch).items()}}
        cache["mlstm"]["m"].fill_(ssm.EMPTY_M)
        cache["slstm"] = {
            k: torch.zeros((units,) + s, device=device, dtype=torch.float32)
            for k, s in ssm.slstm_state_shape(cfg, batch).items()}
        return cache
    if cfg.family == "zamba":
        kv = (n_units(cfg), batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"mamba": {k: torch.zeros((L,) + s, device=device,
                                         dtype=torch.float32 if k == "h" else dt)
                          for k, s in ssm.mamba2_state_shape(cfg, batch).items()},
                "attn_kv": {k: torch.zeros(kv, dtype=dt, device=device)
                            for k in ("k", "v")}}
    return {k: torch.zeros((L, batch, max_len) + row, dtype=dt, device=device)
            for k, row in kv_rows(cfg).items()}


def kv_rows(cfg: ModelConfig) -> dict:
    """The cache leaves of a dense or moe model and the shape of the row
    each holds per (layer, token): K/V heads, or MLA's latent and rope key."""
    if cfg.use_mla:
        return {"c_kv": (cfg.kv_lora_rank,), "k_rope": (cfg.qk_rope_dim,)}
    row = (cfg.n_kv_heads, cfg.head_dim)
    return {"k": row, "v": row}


def make_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     device="cuda", kv_dtype: Optional[str] = None) -> dict:
    """One shared KV page arena ``[L, n_pages, page_size, KV, hd]`` per
    leaf (MLA: ``c_kv`` ``[L, n_pages, page_size, kvr]`` and ``k_rope``
    ``[..., dr]``).

    ``kv_dtype='int8'`` makes the value leaves int8 and adds a float32
    ``<leaf>_scale`` arena, the value leaf's shape minus its last axis
    (one scale per cached row), next to each.
    """
    _decoder_only(cfg)
    if not supports_paged_kv(cfg):
        raise ValueError(
            f"{cfg.name}: {cfg.family!r} family has no paged KV layout")
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
    shapes = {k: (cfg.n_layers, n_pages, page_size) + row
              for k, row in kv_rows(cfg).items()}
    if kv_dtype is None:
        dt = torch_dtype(cfg.dtype)
        return {k: torch.zeros(shape, dtype=dt, device=device)
                for k, shape in shapes.items()}
    cache = {}
    for k, shape in shapes.items():
        cache[k] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache[k + quant.SCALE_SUFFIX] = torch.zeros(
            shape[:-1], dtype=torch.float32, device=device)
    return cache


# ---------------------------------------------------------------------------
# the layer loop
# ---------------------------------------------------------------------------

def _dense_block(bp: dict, x, cfg: ModelConfig, positions, layer_cache,
                 cache_pos, page_table=None, page_size: int = 0,
                 adapters: Optional[dict] = None, adapter_ids=None,
                 aux: Optional[list] = None):
    """One decoder block (pre-norm attention, then the gated MLP or, for
    moe, the expert layer) over its parameters ``bp`` and its layer's
    cache (updated in place).  The layer loop below and the layer-streamed
    prefill (``core.streaming``) both run it.  ``adapters`` is this
    layer's slice of an adapter bank (GQA blocks only).  A moe block
    appends its load-balancing loss to ``aux`` when one is given.  Under
    a sharding plan ``cfg`` is the rank's configuration: MLA runs its
    heads and the moe layer its experts (``models.mla``, ``models.moe``),
    each ending in one ``all_reduce``."""
    h = rmsnorm(x, bp["attn_norm"], cfg.norm_eps)
    if cfg.use_mla:
        if adapters is not None:
            raise NotImplementedError(
                "adapter gather targets the GQA projections, not MLA")
        a, _ = mla.mla_attention_block(bp["attn"], h, cfg, positions,
                                       layer_cache, cache_pos,
                                       page_table=page_table,
                                       page_size=page_size)
    else:
        a, _ = attention_block(bp["attn"], h, cfg, positions, layer_cache,
                               cache_pos, page_table=page_table,
                               page_size=page_size, adapters=adapters,
                               adapter_ids=adapter_ids)
    h, x = rmsnorm(x, bp["mlp_norm"], cfg.norm_eps, residual=a)
    if cfg.n_experts:
        m = moe.moe_block(bp["moe"], h, cfg)
        if aux is not None:
            aux.append(moe.moe_aux_loss(bp["moe"], h, cfg))
        return x + m
    return x + mlp_block(bp["mlp"], h, cfg.act)


def remat_call(fn, x, remat: bool):
    """``fn(x)``; with ``remat`` its activations are recomputed in the
    backward instead of kept (the reference's ``jax.checkpoint`` of a
    block; nothing in a block draws random numbers).  The recomputation
    runs in the context of the forward (a sharding plan's scope and its
    FSDP layout), so it meets the other ranks in the same collectives."""
    if not remat:
        return fn(x)
    ctx = contextvars.copy_context()
    return checkpoint(lambda h: ctx.run(fn, h), x, use_reentrant=False,
                      preserve_rng_state=False)


def layer_cache(cache: Optional[dict], layer: int) -> Optional[dict]:
    """The views of one layer's cache leaves (writes land in ``cache``)."""
    return None if cache is None else {k: t[layer] for k, t in cache.items()}


def _mamba_block(bp: dict, x, cfg: ModelConfig, state: Optional[dict]):
    """One zamba Mamba2 block (pre-norm mixer, residual) over its
    parameters ``bp``; the new recurrent and conv state is written into
    ``state`` (one layer's cache views) in place."""
    y, new_state = ssm.mamba2_mixer(bp["mixer"],
                                    rmsnorm(x, bp["norm"], cfg.norm_eps),
                                    cfg, state)
    if state is not None:
        state["h"].copy_(new_state["h"])
        state["conv"].copy_(new_state["conv"])
    return x + y


def zamba_unit(mamba_params, shared_params, x, cfg: ModelConfig, positions,
               cache: Optional[dict], unit: int, cache_pos,
               remat: bool = False):
    """One zamba unit: ``attn_every`` Mamba2 blocks, then the SHARED
    attention + MLP block (``_dense_block`` over ``shared_attn``) with
    this unit's own K/V cache.  ``mamba_params(l)`` and
    ``shared_params()`` supply the weights when a block needs them, so the
    layer loop below and the layer-streamed prefill (``core.streaming``)
    run the same body and each block waits only for its own weights.
    ``remat`` (training, no cache) recomputes each Mamba2 block in the
    backward, as the reference checkpoints its Mamba2 scan body; a block
    asks for its weights inside the recomputed part, so an FSDP gather
    there runs again."""
    every = cfg.attn_every
    for layer in range(unit * every, (unit + 1) * every):
        state = layer_cache(None if cache is None else cache["mamba"], layer)
        x = remat_call(lambda h, layer=layer, st=state:
                       _mamba_block(mamba_params(layer), h, cfg, st), x, remat)
    kv = layer_cache(None if cache is None else cache["attn_kv"], unit)
    return _dense_block(shared_params(), x, cfg, positions, kv, cache_pos)


def _store(state: Optional[dict], new_state: dict) -> None:
    """Write a mixer's new state into ``state`` (one layer's cache views)."""
    if state is not None:
        for k, t in state.items():
            t.copy_(new_state[k])


def _mlstm_block(bp: dict, x, cfg: ModelConfig, state: Optional[dict]):
    """One xlstm mLSTM block (pre-norm mixer, residual); the new state is
    written into ``state`` (one layer's cache views) in place."""
    y, new_state = ssm.mlstm_mixer(bp["mixer"],
                                   rmsnorm(x, bp["norm"], cfg.norm_eps),
                                   cfg, state)
    _store(state, new_state)
    return x + y


def _slstm_block(sp: dict, x, cfg: ModelConfig, state: Optional[dict]):
    """One xlstm sLSTM block: the pre-norm mixer and its residual, whose
    add the ``mlp_norm`` takes fused (the kernel's residual form), then
    the post-MLP and its residual; the new state lands in ``state``.
    Under a sharding plan the mixer's output comes back whole, and the
    post-MLP is split (its partials meet in one ``all_reduce``) where the
    model axis divides its width, else every rank runs all of it."""
    y, new_state = ssm.slstm_mixer(sp["mixer"],
                                   rmsnorm(x, sp["norm"], cfg.norm_eps),
                                   cfg, state)
    _store(state, new_state)
    h, x = rmsnorm(x, sp["mlp_norm"], cfg.norm_eps, residual=y)
    if cfg.slstm_mlp_split:          # the rank's slice of the width
        return x + mlp_block(sp["mixer"]["mlp"], h, cfg.act)
    return x + mlp_partial(sp["mixer"]["mlp"], h, cfg.act)


def xlstm_unit(mlstm_params, slstm_params, x, cfg: ModelConfig,
               cache: Optional[dict], unit: int, remat: bool = False):
    """One xlstm unit: its ``slstm_every - 1`` mLSTM blocks (mLSTM index
    ``unit * (slstm_every - 1) + j``), then its sLSTM block.
    ``mlstm_params(l)`` and ``slstm_params(unit)`` supply the weights when
    a block needs them, so the layer loop below and the layer-streamed
    prefill (``core.streaming``) run the same body and each block waits
    only for its own weights.  ``remat`` (training, no cache) recomputes
    each mLSTM block in the backward, as the reference checkpoints its
    mLSTM scan body (not the sLSTM block)."""
    _, m_per = xlstm_units(cfg)
    for layer in range(unit * m_per, (unit + 1) * m_per):
        state = layer_cache(None if cache is None else cache["mlstm"], layer)
        x = remat_call(lambda h, layer=layer, st=state:
                       _mlstm_block(mlstm_params(layer), h, cfg, st), x, remat)
    return _slstm_block(slstm_params(unit), x, cfg,
                        layer_cache(None if cache is None else cache["slstm"],
                                    unit))


def sequence_view(cache: dict, b: int) -> dict:
    """Views of sequence ``b``'s rows (axis 1) of every leaf of a nested
    cache, as a batch-1 cache (writes land in ``cache``)."""
    return {k: sequence_view(v, b) if isinstance(v, dict) else v[:, b:b + 1]
            for k, v in cache.items()}


def layer_bank(bank: Optional[dict], layer: int) -> Optional[dict]:
    """One layer's slice of an adapter bank (where the JAX package puts
    the bank into the layer scan's xs)."""
    if bank is None:
        return None
    return {name: {k: t[layer] for k, t in slab.items()}
            for name, slab in bank.items()}


def _decoder(params, cfg, x, positions, cache, cache_pos, page_table=None,
             page_size: int = 0, adapter_bank=None, adapter_ids=None,
             aux: Optional[list] = None, remat: bool = False):
    """The layer loop.  ``aux`` collects the moe blocks' load-balancing
    losses; ``remat`` (training, no cache) recomputes each block the
    reference checkpoints in the backward."""
    if cfg.family in ("zamba", "xlstm") and adapter_bank is not None:
        raise NotImplementedError(
            f"{cfg.name}: adapter gather needs the dense block layout")
    if cfg.family == "xlstm":
        for unit in range(xlstm_units(cfg)[0]):
            x = xlstm_unit(
                lambda l: fsdp.gathered(params["mlstm"][l], f"mlstm.{l}"),
                lambda u: fsdp.gathered(params["slstm"][u], f"slstm.{u}"),
                x, cfg, cache, unit, remat)
        return x
    if cfg.family == "zamba":
        # the shared block is gathered once: its uses' gradients add up in
        # the one gathered leaf, whose backward scatters their sum
        shared = fsdp.gathered(params["shared_attn"], "shared_attn")
        for unit in range(n_units(cfg)):
            x = zamba_unit(
                lambda l: fsdp.gathered(params["mamba"][l], f"mamba.{l}"),
                lambda: shared, x, cfg, positions, cache, unit, cache_pos,
                remat)
        return x
    for layer, bp in enumerate(params["layers"]):
        def block(h, bp=bp, layer=layer):
            out = None if aux is None else []
            bp = fsdp.gathered(bp, f"layers.{layer}")
            h = _dense_block(bp, h, cfg, positions, layer_cache(cache, layer),
                             cache_pos, page_table, page_size,
                             layer_bank(adapter_bank, layer), adapter_ids, out)
            return h, out
        x, out = remat_call(block, x, remat)
        if out:
            aux.extend(out)
    return x


def _head(params, cfg, x, gather: bool = True):
    x = rmsnorm(x, fsdp.gathered(params["final_norm"], "final_norm"),
                cfg.norm_eps)
    head = {k: fsdp.gathered(params[k], k)
            for k in ("embed", "lm_head") if k in params}
    return lm_head(x, head, cfg.tied_embeddings, gather)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            training: bool = False):
    """Full-sequence causal forward -> (logits [B, S, V], aux), ``aux``
    the fp32 sum of the moe blocks' load-balancing losses (0 for the
    other families), as ``repro.models.transformer.forward``.

    ``training=False`` runs under ``no_grad``.  ``training=True`` lets
    gradients flow and, with ``cfg.remat``, recomputes each block the
    reference checkpoints (every dense and moe block; zamba's Mamba2 and
    xlstm's mLSTM blocks) in the backward."""
    _decoder_only(cfg)
    if not training:
        with torch.no_grad():
            return _forward(params, cfg, tokens, False)
    return _forward(params, cfg, tokens, cfg.remat)


def _forward(params, cfg, tokens, remat: bool, gather: bool = True):
    B, S = tokens.shape
    x = embed_tokens(fsdp.gathered(params["embed"], "embed"), tokens,
                     scale_by_dim=cfg.scale_embed)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    auxs: list = []
    x = _decoder(params, cfg, x, positions, None, None, aux=auxs, remat=remat)
    aux = (torch.stack(auxs).sum() if auxs
           else torch.zeros((), dtype=torch.float32, device=x.device))
    return _head(params, cfg, x, gather), aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in fp32: ``logsumexp(logits) - logits[label]``
    (the reference's ``loss_fn`` arithmetic)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def loss_fn(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, aux_weight: float = 0.01) -> torch.Tensor:
    """The training loss of ``repro.models.transformer.loss_fn``: the fp32
    cross-entropy of the training forward plus ``aux_weight`` times its
    moe load-balancing loss."""
    if not sharding.vocab_split():
        logits, aux = forward(params, cfg, tokens, training=True)
        return cross_entropy(logits, labels) + aux_weight * aux
    _decoder_only(cfg)
    logits, aux = _forward(params, cfg, tokens, cfg.remat, gather=False)
    return sharding.vocab_cross_entropy(logits, labels) + aux_weight * aux


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
            adapter_bank: Optional[dict] = None, adapter_ids=None):
    """Process the prompt, fill the cache; returns (last-token logits, cache)."""
    _decoder_only(cfg)
    return _prefill(params, cfg, tokens, cache, 0, adapter_bank, adapter_ids)


@torch.no_grad()
def prefill_from(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 cache: dict, offset: int, adapter_bank: Optional[dict] = None,
                 adapter_ids=None):
    """Suffix-only prefill: ``tokens`` are positions ``offset ..
    offset+S-1`` against a cache whose first ``offset`` positions are
    already filled (a reused prompt prefix).  Positions, RoPE and the
    causal mask carry the offset, and the new K/V land at ``offset``.
    With an ``adapter_bank``, ``adapter_ids`` [B] selects each sequence's
    LoRA row.  Dense and moe families only."""
    _decoder_only(cfg)
    _check_positional(cfg, "suffix-only prefill")
    return _prefill(params, cfg, tokens, cache, int(offset), adapter_bank,
                    adapter_ids)


def _prefill(params, cfg, tokens, cache, offset: int, adapter_bank,
             adapter_ids):
    B, S = tokens.shape
    if cfg.family == "xlstm" and B > 1:
        # an xlstm prefill of several sequences runs them one at a time:
        # cuBLAS picks a product's kernel by its shape, so a batch and one
        # sequence can sum in different orders; on an H100 a sequence
        # prefilled in a batch of 8 got other bits than alone, as the
        # serving engine prefills it (tools/torch_xlstm_batch_bits.py)
        logits = [_prefill(params, cfg, tokens[b:b + 1], sequence_view(cache, b),
                           offset, adapter_bank, adapter_ids)[0]
                  for b in range(B)]
        return torch.cat(logits), cache
    x = embed_tokens(fsdp.gathered(params["embed"], "embed"), tokens,
                     scale_by_dim=cfg.scale_embed)
    positions = (offset + torch.arange(S, device=x.device))[None, :].expand(B, S)
    x = _decoder(params, cfg, x, positions, cache, offset,
                 adapter_bank=adapter_bank, adapter_ids=adapter_ids)
    return _head(params, cfg, x[:, -1:])[:, 0], cache


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos):
    """One decode step over a dense cache.  tokens: [B, 1]; pos: an int
    (whole batch at one position) or an int [B] tensor of per-sequence
    positions."""
    _decoder_only(cfg)
    B = tokens.shape[0]
    x = embed_tokens(fsdp.gathered(params["embed"], "embed"), tokens,
                     scale_by_dim=cfg.scale_embed)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos = pos.reshape(-1).expand(B).contiguous()
    x = _decoder(params, cfg, x, pos[:, None], cache, pos)
    return _head(params, cfg, x)[:, 0], cache


@torch.no_grad()
def decode_step_paged(params: dict, cfg: ModelConfig, cache: dict,
                      tokens: torch.Tensor, pos: torch.Tensor,
                      page_table: torch.Tensor, page_size: int,
                      adapter_bank: Optional[dict] = None, adapter_ids=None):
    """One decode step over a block-paged KV arena (:func:`make_paged_cache`).

    tokens: [B, 1]; pos: int [B] per-sequence positions; page_table:
    [B, NB] int32 physical page per logical block.  With an
    ``adapter_bank``, ``adapter_ids`` [B] selects each slot's LoRA delta
    (0 = null adapter for free and foreign slots).  Dense and moe families
    only."""
    _decoder_only(cfg)
    _check_positional(cfg, "paged decode path")
    x = embed_tokens(fsdp.gathered(params["embed"], "embed"), tokens,
                     scale_by_dim=cfg.scale_embed)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    x = _decoder(params, cfg, x, pos[:, None], cache, pos,
                 page_table=page_table, page_size=page_size,
                 adapter_bank=adapter_bank, adapter_ids=adapter_ids)
    return _head(params, cfg, x)[:, 0], cache
