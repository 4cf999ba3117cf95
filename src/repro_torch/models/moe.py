"""Token-choice top-k Mixture-of-Experts with capacity-based dispatch (the
port's copy of ``repro.models.moe``, same semantics).

Per call of T = B * S tokens, each token picks its top-k experts from a
softmax router; expert e holds at most C = min(max(ceil(T k cf / E), 4), T)
tokens.  A (token, k) pair takes the next free row of its expert's
``[C, D]`` buffer in token-major order; pairs past the capacity are
dropped (they add nothing to the token's output).  Every expert runs over
its whole buffer, used or not, as one batched product over ``[E, C, D]``.

Where the bits could drift from the reference:
  * ties in the router's probabilities break to the lower expert index,
    as ``jax.lax.top_k`` does: a stable descending sort, since
    ``torch.topk`` promises no order among equal values;
  * each kept buffer row receives exactly one token row, and the dropped
    pairs all land on one extra row that nothing reads, so the scatter
    needs no atomic adds and its result does not depend on scheduling;
  * T counts every row of the call: free slots' rows of a decode step
    take capacity too (see ``runtime.continuous``).

Nothing here needs a device: on ``meta`` tensors (tracing) the sort,
cumulative sum and index writes run shape-only.

Checks read the routing through :func:`watch`, which records every call's
expert ids and kept pairs while it is open.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_mlp_params, mlp_block, normal_


def make_moe_params(gen, cfg: ModelConfig) -> dict:
    """Router ``[D, E]`` and the experts' stacked gated MLPs ``[E, D, F]``
    / ``[E, F, D]``, drawn in the reference's order (router, gate, up,
    down, then the shared experts' MLP)."""
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    p = {"router": normal_(gen, (D, E), scale=1.0 / math.sqrt(D)),
         "experts": {"w_gate": normal_(gen, (E, D, Fd)),
                     "w_up": normal_(gen, (E, D, Fd)),
                     "w_down": normal_(gen, (E, Fd, D))}}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp_params(gen, D, Fd * cfg.n_shared_experts)
    return p


_watches: list = []


@contextlib.contextmanager
def watch():
    """Record every :func:`moe_block` call made while open: yields a list
    that gets ``(S, gate_idx [T, K], keep [T*K])`` per call, on the call's
    device (``S == 1`` for a decode step).  No cost when no watch is open."""
    calls = []
    _watches.append(calls)
    try:
        yield calls
    finally:
        _watches.remove(calls)


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert buffer; capacity past ``n_tokens`` is unreachable
    (a token takes at most one row per expert), so cf = E/K is dropless."""
    c = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return min(max(c, 4), n_tokens)


def route(p: dict, xf: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Router of ``xf`` [T, D]: the product in x's dtype, then softmax in
    fp32 and the top-k (ties to the lower index).  Returns the
    renormalized gate weights [T, K] (fp32) and expert ids [T, K]."""
    probs = torch.softmax((xf @ p["router"]).float(), dim=-1)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = gate_w[:, :cfg.top_k], gate_idx[:, :cfg.top_k]
    return gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9), gate_idx


def dispatch(gate_idx: torch.Tensor, cfg: ModelConfig, capacity: int) -> tuple:
    """Buffer rows of the (token, k) pairs in token-major order: expert
    ``e``'s n-th pair takes row ``e * C + n``.  Returns (row [T*K], keep
    [T*K]); a dropped pair's row is ``E * C`` (the discard row)."""
    E = cfg.n_experts
    flat = gate_idx.reshape(-1)
    hits = (flat[:, None] == torch.arange(E, device=flat.device)).to(torch.int32)
    pos = (hits.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    keep = pos < capacity
    row = torch.where(keep, flat * capacity + pos,
                      torch.full_like(pos, E * capacity))
    return row, keep


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = expert_capacity(T, cfg)
    xf = x.reshape(T, D)
    gate_w, gate_idx = route(p, xf, cfg)
    row, keep = dispatch(gate_idx, cfg, C)
    for calls in _watches:
        calls.append((S, gate_idx, keep))

    # scatter: each kept row of the [E, C, D] buffer receives one token row
    buf = x.new_zeros((E * C + 1, D))
    buf.index_copy_(0, row, xf.repeat_interleave(K, dim=0))
    h = buf[:E * C].view(E, C, D)

    ex = p["experts"]
    g, u = torch.bmm(h, ex["w_gate"]), torch.bmm(h, ex["w_up"])
    a = F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")
    out = torch.bmm(a * u, ex["w_down"]).view(E * C, D)

    # gather back, zero the dropped pairs, combine with the gate weights
    safe = torch.where(keep, row, torch.zeros_like(row))
    gathered = out[safe].masked_fill(~keep[:, None], 0)
    y = (gathered.view(T, K, D) * gate_w[..., None].to(x.dtype)).sum(dim=1)
    y = y.view(B, S, D)
    if "shared" in p:
        y = y + mlp_block(p["shared"], x, cfg.act)
    return y



def moe_aux_loss(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The Switch-style load-balancing loss of ``repro.models.moe.
    moe_aux_loss`` over x [B, S, D]: E times the sum over experts of the
    fraction of (token, k) picks each gets and its mean router
    probability.  The router product, softmax and top-k are
    :func:`route`'s (ties to the lower expert); the gradient reaches the
    router through the mean probabilities only.  Returns a fp32 scalar."""
    B, S, D = x.shape
    E = cfg.n_experts
    probs = torch.softmax((x.reshape(B * S, D) @ p["router"]).float(), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :cfg.top_k]
    frac = F.one_hot(idx, E).float().mean(dim=(0, 1))
    return E * (frac * probs.mean(dim=0)).sum()
