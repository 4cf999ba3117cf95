"""Recurrent sequence mixers: Mamba2 (scalar-decay SSD), and xLSTM's
mLSTM and sLSTM.

The port's copy of ``repro.models.ssm``, as plain functions over
tensors.  Mamba2's recurrence ``h = exp(ld) h + B x^T``, ``y = C . h``
runs two ways, branch for branch as in the JAX mixer:

* prefill (S > 1): the ``ssd_scan`` kernel on a card; on the CPU its
  plain versions, the chunked SSD where the chunk divides S and the exact
  recurrence otherwise (the JAX mixer's two branches);
* decode (S == 1): the O(1) step update, a plain update on every device
  (no TPU kernel computes it).

The mLSTM (matrix memory, exponential gates, max-stabilised) runs the
reference's chunked form operation for operation (``mlstm_chunked``),
and the sLSTM its recurrence one step per token; both are PyTorch ops on
every device, as the reference runs them in XLA outside any Pallas
kernel.  Both loops go through :func:`scan`, which over ``meta``
tensors runs the stand-in of a shape-only reckoning where one is set
(``distributed.dry``).  Their RMSNorms go through the ``rmsnorm``
kernel.

Under a sharding plan each mixer runs the rank's heads (``cfg`` is the
rank's configuration, ``distributed.sharding.local_config``): the norm
over a row the ranks split takes the split-row form
(``layers.split_rmsnorm``), Mamba2's ``out_proj`` and the mLSTM's
``down_proj`` end in one ``all_reduce``, and the sLSTM's heads are
gathered to the whole row.  The xLSTM's heads may split unevenly
(``distributed.sharding.head_split``): a rank's widths are its heads',
the split-row norms and the sLSTM's gather take the whole row's, and a
rank holding no head runs its products on empty tensors (zeros into
the sums).  For training, each mixer's input enters the
rank's heads through ``sharding.copy_to_model`` (its gradient summed
over the ranks), and the replicated weights that turn it into what
every head reads (Mamba2's B / C columns of ``in_proj`` and ``conv_w``,
the mLSTM's ``x_inner`` columns of ``up_proj`` and its conv) have their
gradients summed over the ranks (``sharding.sum_grad_columns``): each
rank's is its heads' part.

States are carried in float32.
"""

from __future__ import annotations

import contextvars
import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDraw, normal_, split_rmsnorm


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
    package's layout.  ``gen=None`` gives uninitialized tensors (specs).
    Under a sharding plan ``cfg`` is the rank's: its heads' channels."""
    D = cfg.d_model
    d_inner = cfg.mamba_width
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
    new_state); the caller stores the new state.

    Under a sharding plan ``cfg`` is the rank's: its heads' channels of
    z, x and dt (B and C whole: every head reads them), the gated norm
    over the row the ranks split (``split_rmsnorm``) and ``out_proj``'s
    partial sums meeting in one ``all_reduce``."""
    B, S, D = x.shape
    d_inner = cfg.mamba_width
    H, ds = cfg.ssm_heads, cfg.ssm_state
    dh = d_inner // H

    bc = 2 * d_inner, 2 * d_inner + 2 * ds           # B and C's columns
    zxbcdt = (sharding.copy_to_model(x)
              @ sharding.sum_grad_columns(p["in_proj"], *bc))
    z = zxbcdt[..., :d_inner]
    xc = zxbcdt[..., d_inner:2 * d_inner + 2 * ds]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * ds:]

    conv_w = sharding.sum_grad_columns(p["conv_w"], d_inner, d_inner + 2 * ds)
    xc, new_conv = causal_conv1d(xc, conv_w,
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
    y = split_rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return sharding.all_reduce(y @ p["out_proj"]), {"h": hK, "conv": new_conv}


def mamba2_state_shape(cfg: ModelConfig, batch: int) -> dict:
    d_inner = cfg.mamba_width
    H, ds = cfg.ssm_heads, cfg.ssm_state
    conv_ch = d_inner + 2 * ds
    return {
        "h": (batch, H, d_inner // H, ds),
        "conv": (batch, cfg.conv_width - 1, conv_ch),
    }


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory, exponential gating, max-stabilised)
# ---------------------------------------------------------------------------

# "empty history" value of the running max-stabiliser m: a large negative
# finite constant (not -inf), so exp(m_prev - m_new) underflows to exactly
# 0 without inf - inf; every fresh mLSTM cache starts from it
EMPTY_M = -1e9


def make_mlstm_params(gen: Optional[ParamDraw], cfg: ModelConfig) -> dict:
    """One mLSTM mixer's parameters in the JAX package's layout (fan-in
    scaled normals; the gate bias zeros, the inner norm ones).
    ``gen=None`` gives uninitialized tensors (specs).  Under a sharding
    plan ``cfg`` is the rank's: ``x_inner`` (its conv and the input of
    ``wq`` / ``wk`` / ``wv`` / ``w_if``) whole, the heads' columns its
    own."""
    D = cfg.d_model
    d_in, d_inner = cfg.mlstm_input_width, cfg.mlstm_width
    H = cfg.n_heads
    return {
        "up_proj": normal_(gen, (D, d_in + d_inner)),         # x_inner, z gate
        "conv_w": normal_(gen, (cfg.conv_width, d_in), scale=0.5),
        "wq": normal_(gen, (d_in, d_inner)),
        "wk": normal_(gen, (d_in, d_inner)),
        "wv": normal_(gen, (d_in, d_inner)),
        "w_if": normal_(gen, (d_in, 2 * H), scale=0.01),      # input, forget
        "b_if": torch.zeros(2 * H),
        "norm": torch.ones(d_inner),
        "down_proj": normal_(gen, (d_inner, D)),
    }


# a stand-in for :func:`scan` over ``meta`` tensors, or None
# (``distributed.dry.peak_bytes`` sets one for its shape-only reckoning)
META_SCAN: contextvars.ContextVar = contextvars.ContextVar("meta_scan",
                                                          default=None)


def scan(step: Callable, xs: tuple, state: tuple) -> tuple:
    """A recurrence over axis 1 of ``xs`` (each [B, T, ...]), one step at
    a time: ``step(*x_t, *state) -> (y_t, state)``.  Returns (the ``y_t``
    stacked on axis 1, the last state).  Over ``meta`` tensors the
    stand-in in ``META_SCAN`` runs instead, where one is set."""
    stand_in = META_SCAN.get()
    if stand_in is not None and xs[0].is_meta:
        return stand_in(step, xs, state)
    ys = []
    for t in range(xs[0].shape[1]):
        y, state = step(*(x[:, t] for x in xs), *state)
        ys.append(y)
    return torch.stack(ys, dim=1), tuple(state)


def mlstm_chunked(q, k, v, i_raw, f_raw, chunk: int,
                  state: Optional[dict] = None):
    """The stabilised chunked mLSTM of the reference (``_mlstm_chunked``).

    q, k, v: [B, S, H, dh]; i_raw, f_raw: [B, S, H]; ``state`` {'C': [B,
    H, dh, dh], 'n': [B, H, dh], 'm': [B, H]} float32, or None (zeros and
    ``EMPTY_M``).  Chunks of ``Q = min(chunk, S)`` rows, and S must be a
    multiple of Q (the reference asserts it).  Returns (y [B, S, H, dh] in
    q's dtype, final state)."""
    Bb, S, H, dh = q.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"mlstm: sequence length {S} is not a multiple of "
                         f"the chunk {Q}")
    K = S // Q
    f32 = torch.float32
    scale = 1.0 / math.sqrt(dh)

    qc = q.reshape(Bb, K, Q, H, dh).to(f32) * scale
    kc = k.reshape(Bb, K, Q, H, dh).to(f32)
    vc = v.reshape(Bb, K, Q, H, dh).to(f32)
    ic = i_raw.reshape(Bb, K, Q, H).to(f32)
    logf = F.logsigmoid(f_raw.reshape(Bb, K, Q, H).to(f32))
    F_cum = torch.cumsum(logf, dim=2)                          # [B,K,Q,H]
    F_tot = F_cum[:, :, -1, :]

    if state is None:
        C = torch.zeros((Bb, H, dh, dh), dtype=f32, device=q.device)
        n = torch.zeros((Bb, H, dh), dtype=f32, device=q.device)
        m = torch.full((Bb, H), EMPTY_M, dtype=f32, device=q.device)
    else:
        C, n, m = state["C"], state["n"], state["m"]

    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    y, (C, n, m) = scan(functools.partial(_mlstm_chunk, causal=causal),
                        (qc, kc, vc, ic, F_cum, F_tot), (C, n, m))
    y = y.reshape(Bb, S, H, dh)
    return y.to(q.dtype), {"C": C, "n": n, "m": m}


def _mlstm_chunk(qq, kk, vv, ii, Fc, Ft, C, n, m, causal):
    """One chunk of :func:`mlstm_chunked`: its rows' outputs and the
    chunk-end state, ``(y, (C, n, m))``."""
    neg_inf = torch.finfo(torch.float32).min
    # intra-chunk log weights W[i, j] = F_i - F_j + i_j
    W = Fc[:, :, None, :] - Fc[:, None, :, :] + ii[:, None, :, :]  # [B,i,j,H]
    W = torch.where(causal[None, :, :, None], W, neg_inf)
    inter = Fc + m[:, None, :]                                 # [B,i,H]
    m_new = torch.maximum(W.amax(dim=2), inter)
    m_new = torch.clamp_min(m_new, -30.0)                      # no -inf rows
    w = torch.exp(W - m_new[:, :, None, :])                    # [B,i,j,H]
    s = torch.exp(inter - m_new)                               # [B,i,H]

    qk = torch.einsum("bihd,bjhd->bijh", qq, kk)
    h_num = (torch.einsum("bijh,bjhd->bihd", qk * w, vv)
             + torch.einsum("bihd,bhde->bihe", qq, C) * s[..., None])
    n_vec = (torch.einsum("bijh,bjhd->bihd", w, kk)
             + s[..., None] * n[:, None, :, :])
    denom = torch.maximum(torch.einsum("bihd,bihd->bih", qq, n_vec).abs(),
                          torch.exp(-m_new))
    y = h_num / denom[..., None]

    # the chunk-end state
    Wend = Ft[:, None, :] - Fc + ii                            # [B,j,H]
    m_end = torch.maximum(Wend.amax(dim=1), Ft + m)
    m_end = torch.clamp_min(m_end, -30.0)
    wend = torch.exp(Wend - m_end[:, None, :])
    send = torch.exp(Ft + m - m_end)
    C = (torch.einsum("bjhd,bjhe->bhde", wend[..., None] * kk, vv)
         + send[:, :, None, None] * C)
    n = torch.einsum("bjh,bjhd->bhd", wend, kk) + send[..., None] * n
    return y, (C, n, m_end)


def mlstm_mixer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None):
    """xLSTM mLSTM block body.  x: [B, S, D] -> ([B, S, D], new_state).

    ``state`` ({'C', 'n', 'm'} float32 and 'conv' [B, W-1, d_inner] in the
    model dtype) seeds the recurrence and the conv; None means a fresh
    one.  The caller stores the new state.

    Under a sharding plan ``cfg`` is the rank's: ``x_inner`` and its conv
    whole (every head's q, k and v contract over all of it), the rank's
    heads of q, k, v, the gates and ``z``, the norm over the row the
    ranks split (``split_rmsnorm``) and ``down_proj``'s partial sums
    meeting in one ``all_reduce``."""
    B, S, D = x.shape
    d_in, d_inner = cfg.mlstm_input_width, cfg.mlstm_width
    H = cfg.n_heads
    dh = cfg.mlstm_head_dim

    up = (sharding.copy_to_model(x)
          @ sharding.sum_grad_columns(p["up_proj"], 0, d_in))
    xi, z = up[..., :d_in], up[..., d_in:]
    xq, new_conv = causal_conv1d(xi, sharding.sum_grad_columns(p["conv_w"]),
                                 None if state is None else state["conv"])
    xq = F.silu(xq)

    q = (xq @ p["wq"]).reshape(B, S, H, dh)
    # the reference divides by a numpy float64, which promotes k to float32
    k = (xq @ p["wk"]).reshape(B, S, H, dh).float() / math.sqrt(dh)
    v = (xi @ p["wv"]).reshape(B, S, H, dh)
    gates = xi @ p["w_if"] + p["b_if"]
    i_raw, f_raw = gates[..., :H], gates[..., H:]

    y, new_inner = mlstm_chunked(q, k, v, i_raw, f_raw, cfg.ssm_chunk, state)

    y = y.reshape(B, S, d_inner)
    y = split_rmsnorm(y, p["norm"], cfg.norm_eps,
                      cfg.heads_total * dh) * F.silu(z)
    return (sharding.all_reduce(y @ p["down_proj"]),
            {"conv": new_conv, **new_inner})


def mlstm_state_shape(cfg: ModelConfig, batch: int) -> dict:
    H = cfg.n_heads
    dh = cfg.mlstm_head_dim
    return {
        "C": (batch, H, dh, dh),
        "n": (batch, H, dh),
        "m": (batch, H),
        "conv": (batch, cfg.conv_width - 1, cfg.mlstm_input_width),
    }


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, a true recurrence: one step per token)
# ---------------------------------------------------------------------------

def make_slstm_params(gen: Optional[ParamDraw], cfg: ModelConfig) -> dict:
    """One sLSTM mixer's parameters, its post-MLP under ``mlp``, in the JAX
    package's layout.  ``gen=None`` gives uninitialized tensors (specs).
    Under a sharding plan ``cfg`` is the rank's: its heads' columns of
    ``w_in`` (head-major), rows of ``r`` and its slice of the post-MLP
    where the model axis divides its width."""
    D = cfg.d_model
    H = cfg.n_heads
    width = cfg.slstm_width
    dh = cfg.slstm_head_dim
    F_mlp = cfg.slstm_mlp_width
    return {
        "w_in": normal_(gen, (D, 4 * width)),                 # z, i, f, o
        "r": normal_(gen, (H, dh, 4 * dh), scale=0.1),        # block-diagonal
        "b": torch.zeros(4 * width),
        "norm": torch.ones(width),
        "mlp": {
            "w_gate": normal_(gen, (D, F_mlp)),
            "w_up": normal_(gen, (D, F_mlp)),
            "w_down": normal_(gen, (F_mlp, D)),
        },
    }


def slstm_mixer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict] = None):
    """sLSTM with an exponential input gate and a stabiliser.  x: [B, S, D].

    ``state`` ({'c', 'n', 'h', 'm'}: [B, H, dh] float32) seeds the
    recurrence; None means zeros.  Returns (y [B, S, D], new_state).

    Under a sharding plan ``cfg`` is the rank's: its heads run their
    recurrence alone (``r`` is block-diagonal), the norm runs over the
    row the ranks split (``split_rmsnorm``) and the rank's heads are
    gathered to the whole row (``gather_columns``)."""
    B, S, D = x.shape
    H = cfg.n_heads
    width = cfg.slstm_width
    dh = cfg.slstm_head_dim
    f32 = torch.float32

    pre = sharding.copy_to_model(x) @ p["w_in"] + p["b"]       # [B,S,4w]
    pre = pre.reshape(B, S, H, 4 * dh).to(f32)

    if state is None:
        c, n, h, m = (torch.zeros((B, H, dh), dtype=f32, device=x.device)
                      for _ in range(4))
    else:
        c, n, h, m = state["c"], state["n"], state["h"], state["m"]

    r = p["r"].to(f32)
    y, (c, n, h, m) = scan(functools.partial(_slstm_step, r=r, dh=dh),
                           (pre,), (c, n, h, m))
    y = y.reshape(B, S, width).to(x.dtype)
    whole = cfg.heads_total * dh
    y = split_rmsnorm(y, p["norm"], cfg.norm_eps, whole)
    return (sharding.gather_columns(y, cfg.head_first * dh, whole),
            {"c": c, "n": n, "h": h, "m": m})


def _slstm_step(pre, c, n, h, m, r, dh: int) -> tuple:
    """One sLSTM step (``pre`` [B, H, 4 dh]) -> ``(h, (c, n, h, m))``,
    the step's output and the new state."""
    g = pre + torch.einsum("bhd,hde->bhe", h, r)              # [B,H,4dh]
    z_t = torch.tanh(g[..., 0 * dh:1 * dh])
    i_t = g[..., 1 * dh:2 * dh]
    f_t = g[..., 2 * dh:3 * dh]
    o_t = torch.sigmoid(g[..., 3 * dh:4 * dh])
    logf_m = F.logsigmoid(f_t) + m
    m_new = torch.maximum(logf_m, i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(logf_m - m_new)
    c = f_s * c + i_s * z_t
    n = f_s * n + i_s
    h = o_t * c / torch.clamp_min(n, 1e-6)
    return h, (c, n, h, m_new)


def slstm_state_shape(cfg: ModelConfig, batch: int) -> dict:
    H = cfg.n_heads
    dh = cfg.slstm_head_dim
    return {"c": (batch, H, dh), "n": (batch, H, dh),
            "h": (batch, H, dh), "m": (batch, H, dh)}
