"""Recurrent sequence mixers: Mamba2 (scalar-decay SSD).

The port's copy of the Mamba2 part of ``repro.models.ssm``, as plain
functions over tensors.  The recurrence ``h = exp(ld) h + B x^T``,
``y = C . h`` runs two ways, branch for branch as in the JAX mixer:

* prefill (S > 1): the ``ssd_scan`` kernel on a card; on the CPU its
  plain versions, the chunked SSD where the chunk divides S and the exact
  recurrence otherwise (the JAX mixer's two branches);
* decode (S == 1): the O(1) step update, a plain update on every device
  (no TPU kernel computes it).

States are carried in float32.  mLSTM and sLSTM (xLSTM) are not ported
yet (ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDraw, normal_, rmsnorm


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """x: [B, S, C]; w: [W, C] depthwise.  Returns (y, new_state [B, W-1, C]).

    With ``state`` (the trailing ``W - 1`` inputs of the previous call)
    this is streaming decode; without it the sequence is left-padded with
    zeros."""
    B, S, C = x.shape
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                          # [B, S+W-1, C]
    y = xp[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    return y, xp[:, S:]


def init_mamba2_params(gen: Optional[ParamDraw], cfg: ModelConfig) -> dict:
    """One Mamba2 mixer's parameters (fan-in scaled normals; ``dt_bias``
    and ``a_log`` zeros, ``d_skip`` and the gated norm ones), in the JAX
    package's layout.  ``gen=None`` gives uninitialized tensors (specs)."""
    D = cfg.d_model
    d_inner = cfg.ssm_expand * D
    H, ds = cfg.ssm_heads, cfg.ssm_state
    conv_ch = d_inner + 2 * ds                  # x, B, C go through the conv
    return {
        "in_proj": normal_(gen, (D, 2 * d_inner + 2 * ds + H)),   # z x B C dt
        "conv_w": normal_(gen, (cfg.conv_width, conv_ch), scale=0.5),
        "dt_bias": torch.zeros(H),
        "a_log": torch.zeros(H),
        "d_skip": torch.ones(H),
        "norm": torch.ones(d_inner),
        "out_proj": normal_(gen, (d_inner, D)),
    }


def ssd_step(xb, B_mat, C_mat, log_decay, h):
    """One decode step of the recurrence (the JAX mixer's step branch at
    S == 1): xb [B, 1, H, dh], B/C [B, 1, ds], log_decay [B, 1, H], h
    [B, H, dh, ds].  Returns (y [B, 1, H, dh], h), float32."""
    h = torch.exp(log_decay[:, 0])[:, :, None, None] * h + torch.einsum(
        "bs,bhd->bhds", B_mat[:, 0].float(), xb[:, 0])
    return torch.einsum("bs,bhds->bhd", C_mat[:, 0].float(), h)[:, None], h


def mamba2_mixer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[dict] = None):
    """Mamba2 block body.  x: [B, S, D].

    ``state`` ({'h': [B, H, dh, ds] fp32, 'conv': [B, W-1, conv_ch]}) seeds
    the recurrence and the conv; None means zeros.  Returns (y [B, S, D],
    new_state); the caller stores the new state."""
    B, S, D = x.shape
    d_inner = cfg.ssm_expand * D
    H, ds = cfg.ssm_heads, cfg.ssm_state
    dh = d_inner // H

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_inner]
    xc = zxbcdt[..., d_inner:2 * d_inner + 2 * ds]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * ds:]

    xc, new_conv = causal_conv1d(xc, p["conv_w"],
                                 None if state is None else state["conv"])
    xc = F.silu(xc)
    xs = xc[..., :d_inner].reshape(B, S, H, dh)
    B_mat = xc[..., d_inner:d_inner + ds]
    C_mat = xc[..., d_inner + ds:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())           # [B,S,H]
    a = -torch.exp(p["a_log"].float())                               # [H]
    log_decay = dt * a                                               # [B,S,H]
    xb = xs.float() * dt[..., None]

    h0 = None if state is None else state["h"].float()
    if S > 1:
        y, hK = ops.ssd_scan(xb, B_mat, C_mat, log_decay, cfg.ssm_chunk, h0)
    else:                              # decode: the O(1) update, any device
        if h0 is None:
            h0 = torch.zeros((B, H, dh, ds), dtype=torch.float32, device=x.device)
        y, hK = ssd_step(xb, B_mat, C_mat, log_decay, h0)

    y = y.to(x.dtype) + xs * p["d_skip"][:, None].to(x.dtype)
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"h": hK, "conv": new_conv}


def mamba2_state_shape(cfg: ModelConfig, batch: int) -> dict:
    d_inner = cfg.ssm_expand * cfg.d_model
    H, ds = cfg.ssm_heads, cfg.ssm_state
    conv_ch = d_inner + 2 * ds
    return {
        "h": (batch, H, d_inner // H, ds),
        "conv": (batch, cfg.conv_width - 1, conv_ch),
    }
