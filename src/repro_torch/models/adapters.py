"""Batched multi-adapter LoRA: many functions, one resident base model.

The port of ``repro.models.adapters``.  Co-resident functions share ONE
base model plus an **adapter bank**, stacked low-rank factors

    a: [L, n_adapters, in_dim, rank]     b: [L, n_adapters, rank, out_dim]

for each targeted attention projection, on the model's device.  Every
decode batch carries a per-slot ``adapter_ids`` vector; each layer slices
its own ``bank[name]["a"][l]`` and gathers the slot's rows, and the
low-rank delta ``(x @ a) @ b`` is added to the base projection
(S-LoRA-style batched serving).  No TPU kernel computes the gather, so
it is an ``index_select`` and two batched products.

Adapter id 0 is the NULL adapter: its factors are all zero, so free and
foreign slots of an owner-masked decode batch add a zero delta, as the
paged arena's null page does for KV.

Under a sharding plan (the model's) a bank holds the rank's shard, split
as its targets are (``distributed.sharding.adapter_bank_specs``): ``b``
of ``wq`` / ``wk`` / ``wv`` by columns, the rank's query or KV heads
(where the KV heads are fewer than the ranks, the KV head the rank
reads, as ``wk`` / ``wv`` keep it), and ``a`` of ``wo`` by rows, the
rank's heads times ``head_dim``; the other factor is whole.  So the
q/k/v deltas are the rank's heads, and the wo delta, computed from the
rank's attention output and its rows of ``a``, is the rank's partial sum
that joins the base projection's before the layer's one ``all_reduce``.
Row 0 stays the null adapter on every rank.  :func:`make_adapter_bank`
and the row writes of :func:`load_adapter` are device ops of the
tensor-parallel channel: every rank builds and writes its own shard from
the same host factors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.group import mirrored

ATTN_TARGETS = ("wq", "wk", "wv", "wo")


def _target_name(path: str) -> str:
    """A checkpoint target path (``blocks.attn.wq``) or a bare projection
    name (``wq``) as its projection name."""
    name = path.rsplit(".", 1)[-1]
    if name not in ATTN_TARGETS:
        raise ValueError(
            f"adapter target {path!r}: only attention projections "
            f"{ATTN_TARGETS} support batched adapter gather")
    return name


def target_dims(cfg, name: str) -> tuple:
    """(in_dim, out_dim) of one attention projection."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
            "wo": (H * hd, D)}[name]


def check_bank_config(model, target_paths, n_adapters: int) -> None:
    """Raise early when a model/bank combination could never serve."""
    cfg = model.cfg
    if cfg.family not in ("dense", "moe"):
        raise ValueError(
            f"{cfg.name}: adapter banks need the stacked dense/moe "
            f"block layout, not family {cfg.family!r}")
    if cfg.use_mla or cfg.fused_qkv:
        raise ValueError(
            f"{cfg.name}: adapter gather targets the unfused GQA "
            "projections (wq/wk/wv/wo)")
    if n_adapters < 2:
        raise ValueError("n_adapters must be >= 2 (id 0 is the null adapter)")
    for path in target_paths:
        _target_name(path)


@mirrored(register=("return",))
def make_adapter_bank(model, target_paths, n_adapters: int, rank: int,
                      dtype=None) -> dict:
    """An all-zero adapter bank for ``model`` on its device:
    ``{name: {"a": [L, N, in, r], "b": [L, N, r, out]}}`` per targeted
    projection.  Every id is the null adapter until :func:`load_adapter`
    writes its factors; id 0 stays null forever.  Under the model's
    sharding plan the rank's shard of it: ``in`` and ``out`` are the
    rank's widths of the target."""
    cfg = model.cfg
    check_bank_config(model, target_paths, n_adapters)
    dt = dtype or cfg.dtype
    dt = getattr(torch, dt) if isinstance(dt, str) else dt
    L = cfg.n_layers
    bank = {}
    for path in target_paths:
        name = _target_name(path)
        din, dout = target_dims(model.local_cfg, name)
        bank[name] = {
            "a": torch.zeros((L, n_adapters, din, rank), dtype=dt,
                             device=model.device),
            "b": torch.zeros((L, n_adapters, rank, dout), dtype=dt,
                             device=model.device)}
    return bank


def bank_n_adapters(bank: dict) -> int:
    """Adapter capacity of a bank (including the reserved null id 0)."""
    return next(iter(bank.values()))["a"].shape[1]


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def load_adapter(bank: dict, idx: int, adapter, model,
                 alpha: float = 1.0) -> dict:
    """Write one ``lora_checkpoint``'s factors into bank row ``idx``.

    ``adapter`` holds ``<path>.A`` ([L*in, r]) / ``<path>.B`` ([r, out])
    arrays per target, at the model's GLOBAL widths.  The per-layer
    slices of A land in ``a[:, idx]``; B (shared across layers in the
    checkpoint) is scaled by ``alpha`` in the checkpoint's dtype, cast,
    and broadcast over the layer axis, as the JAX package does.  Under a
    sharding plan each rank writes its shard of both (the rows run on
    every rank, the factors crossing as host arrays).  The bank's tensors
    are written IN PLACE (the JAX package returns an updated copy; here
    the engine's bank is updated between steps, which run in order on
    one stream).  Returns ``bank``.
    """
    n = bank_n_adapters(bank)
    if not (1 <= idx < n):
        raise ValueError(
            f"adapter idx {idx} out of range [1, {n}) (0 is the null id)")
    arrays = {k: (v() if callable(v) else v)
              for k, v in adapter.arrays.items()}
    _write_rows(bank, idx, {k: torch.as_tensor(_f32(v))
                            for k, v in arrays.items()}, model, float(alpha))
    return bank


@mirrored()
def _write_rows(bank: dict, idx: int, arrays: dict, model,
                alpha: float) -> None:
    """Bank row ``idx`` from host fp32 factors (see :func:`load_adapter`),
    the rank's shard of them under the model's plan."""
    cfg = model.cfg
    L = cfg.n_layers
    plan = model.plan
    specs = (None if plan is None else
             sharding.adapter_bank_specs(cfg, list(bank), plan.tp))
    for path in sorted({k.rsplit(".", 1)[0] for k in arrays}):
        name = _target_name(path)
        if name not in bank:
            raise ValueError(
                f"adapter targets {path!r} but the bank has no "
                f"{name!r} slab (bank targets: {sorted(bank)})")
        din, dout = target_dims(cfg, name)
        a = arrays[path + ".A"].numpy()
        b = arrays[path + ".B"].numpy()
        slab = bank[name]
        rank = slab["a"].shape[-1]
        if a.shape != (L * din, rank) or b.shape != (rank, dout):
            raise ValueError(
                f"{path}: factor shapes {a.shape}/{b.shape} do not fit "
                f"a [{din}, {dout}] projection at bank rank {rank}")
        a_l = torch.from_numpy(a.reshape(L, din, rank))
        b_l = torch.from_numpy((b * np.float32(alpha)).astype(np.float32))
        b_l = b_l[None].expand(L, rank, dout)
        if specs is not None:
            # a row of the bank is [L, in, r] / [L, r, out]: the leaf specs
            # without the adapter axis
            a_l = plan.shard(a_l, _row_spec(specs[name]["a"]))
            b_l = plan.shard(b_l, _row_spec(specs[name]["b"]))
        dt, dev = slab["a"].dtype, slab["a"].device
        slab["a"][:, idx] = a_l.to(dev, dt)
        slab["b"][:, idx] = b_l.to(dev, dt)


def _row_spec(spec):
    return sharding.P(*(spec[:1] + spec[2:]), parts=spec.parts)


def lora_delta(x: torch.Tensor, slab: dict,
               adapter_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sequence low-rank delta of one projection.

    ``x``: [B, S, in]; ``slab``: one bank entry sliced to a layer
    (``{"a": [N, in, r], "b": [N, r, out]}``); ``adapter_ids``: [B] int
    (0 = null adapter = zero delta).  Returns [B, S, out] in x's dtype;
    as in the JAX package, the products run in the bank's dtype and only
    the result is cast.
    """
    ids = adapter_ids.to(device=x.device, dtype=torch.long)
    a = slab["a"].index_select(0, ids)                  # [B, in, r]
    b = slab["b"].index_select(0, ids)                  # [B, r, out]
    t = torch.bmm(x.to(a.dtype), a)
    return torch.bmm(t, b).to(x.dtype)
