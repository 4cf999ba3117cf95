"""Analytic per-step FLOP / HBM-byte counters for the roofline terms: the
port's copy of ``repro.launch.analytic_cost``.

Every model here is a homogeneous stack, so exact per-layer counting is
straightforward.  The counts are taken over the full config's parameters
and caches as ``meta`` tensors (``Model.param_specs``, ``make_cache(...,
device='meta')``): nothing is allocated and no device is touched, even
for deepseek-v3-671b at 128 sequences of 32k tokens.

Counting conventions (the reference's):
  * matmul flops = 2 * M * N * K; backward = 2x forward; remat re-runs the
    forward once more (factor 3 -> 4 on layer matmuls when cfg.remat);
  * attention scores/PV flops = 2 * 2 * B * S^2/2 * H * hd (causal) for
    full-attention archs; SSD/mLSTM chunked terms for recurrent archs;
  * HBM bytes: weights touched once per use (fwd; 2x more in bwd; + opt
    update reads/writes), activations written+read once per layer boundary
    (remat doubles the writes), KV cache read fully per decode step.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import SHAPES, get_model
from repro_torch.utils import named_leaves, tensor_nbytes


@dataclasses.dataclass
class StepCost:
    flops: float
    hbm_bytes: float


def _param_bytes(model, dtype_bytes=2) -> int:
    return sum(leaf.numel() * dtype_bytes
               for _, leaf in named_leaves(model.param_specs()))


def _cache_bytes(model, batch: int, seq: int) -> int:
    cache = model.make_cache(batch, seq, device="meta")
    return sum(tensor_nbytes(leaf) for _, leaf in named_leaves(cache))


def _attn_quadratic_flops(cfg: ModelConfig, B: int, S: int, T: int,
                          n_layers: int) -> float:
    """QK^T + PV over all layers that have attention."""
    if cfg.family == "xlstm":
        return _recurrent_flops(cfg, B, S)
    hd = cfg.head_dim or (cfg.d_model // cfg.n_heads)
    if cfg.use_mla:
        hd = cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim
    per_layer = 2.0 * 2.0 * B * S * T * cfg.n_heads * hd
    if S == T:
        per_layer /= 2                      # causal
    if cfg.family == "zamba":
        n_attn = cfg.n_layers // cfg.attn_every
        return per_layer * n_attn + _recurrent_flops(cfg, B, S)
    if cfg.is_encdec:
        # encoder self (S_enc^2) + decoder self + cross handled by caller
        return per_layer * n_layers
    return per_layer * n_layers


def _recurrent_flops(cfg: ModelConfig, B: int, S: int) -> float:
    """Chunked SSD / mLSTM intra+inter terms."""
    Q = cfg.ssm_chunk
    if cfg.family == "zamba":
        d_inner = cfg.ssm_expand * cfg.d_model
        H, ds = cfg.ssm_heads, cfg.ssm_state
        dh = d_inner // H
        K = max(S // Q, 1)
        intra = 2.0 * B * K * (Q * Q * ds + Q * Q * H * dh)   # CB^T + (w)X
        inter = 2.0 * B * K * Q * H * dh * ds * 2
        return (intra + inter) * cfg.n_layers
    if cfg.family == "xlstm":
        d_inner = int(cfg.mlstm_proj_factor * cfg.d_model)
        H = cfg.n_heads
        dh = d_inner // H
        K = max(S // Q, 1)
        intra = 2.0 * B * K * Q * Q * H * dh * 2              # qk + (w)v
        inter = 2.0 * B * K * Q * H * dh * dh * 2             # qC + kv^T
        n_m = cfg.n_layers - (cfg.n_layers // cfg.slstm_every
                              if cfg.slstm_every else 0)
        mlstm = (intra + inter) * n_m
        # sLSTM: recurrent matvec 4*dh per head per step
        n_s = (cfg.n_layers // cfg.slstm_every) if cfg.slstm_every else 0
        slstm = 2.0 * B * S * H * dh * 4 * dh * n_s
        return mlstm + slstm
    return 0.0


def step_cost(arch: str, shape_name: str) -> StepCost:
    """Global (all-chips) flops and HBM bytes for one step of the cell."""
    model = get_model(arch, device="meta")
    cfg = model.cfg
    sh = SHAPES[shape_name]
    mode, S, B = sh["mode"], sh["seq"], sh["batch"]
    dt = 2                                   # bf16

    pbytes = _param_bytes(model, dt)
    n_params = pbytes / dt

    # active params for MoE (top-k routed + shared + non-expert)
    if cfg.n_experts:
        expert_bytes = sum(
            leaf.numel() * dt
            for path, leaf in named_leaves(model.param_specs())
            if "experts" in path)
        active_bytes = (pbytes - expert_bytes
                        + expert_bytes * cfg.top_k / cfg.n_experts)
        n_active = active_bytes / dt
    else:
        active_bytes = pbytes
        n_active = n_params

    if mode == "train":
        tokens = B * S
        mm = 2.0 * n_active * tokens          # fwd matmuls
        attn = _attn_quadratic_flops(cfg, B, S, S, cfg.n_layers)
        fwd = mm + attn
        factor = 3.0 + (1.0 if cfg.remat else 0.0)   # bwd 2x + remat fwd
        flops = fwd * factor
        act_bytes = 2.0 * dt * tokens * cfg.d_model * max(cfg.n_layers, 1) \
            * (2.0 if cfg.remat else 1.0)
        logits_bytes = dt * tokens * cfg.vocab_size * 2
        # weights: fwd read + bwd read + grad write + opt m/v read/write
        weight_traffic = pbytes * (2 + 1) + pbytes * 2 * 2
        hbm = weight_traffic + act_bytes + logits_bytes
        return StepCost(flops=flops, hbm_bytes=hbm)

    if mode == "prefill":
        tokens = B * S
        flops = 2.0 * n_active * tokens \
            + _attn_quadratic_flops(cfg, B, S, S, cfg.n_layers)
        cache_bytes = _cache_bytes(model, B, S)
        act_bytes = 2.0 * dt * tokens * cfg.d_model * cfg.n_layers
        hbm = active_bytes + cache_bytes + act_bytes \
            + dt * B * cfg.vocab_size
        return StepCost(flops=flops, hbm_bytes=hbm)

    # decode: one token, full cache read
    cache_bytes = _cache_bytes(model, B, S)
    flops = 2.0 * n_active * B \
        + _attn_quadratic_flops(cfg, B, 1, S, cfg.n_layers)
    hbm = active_bytes + cache_bytes + dt * B * cfg.vocab_size
    return StepCost(flops=flops, hbm_bytes=hbm)
