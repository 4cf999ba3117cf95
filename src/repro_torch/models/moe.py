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

Under a sharding plan (expert parallelism) ``cfg`` is the rank's
configuration (``distributed.sharding.local_config``): it keeps the
global ``n_experts`` and capacity factor, and its ``expert_range`` names
the experts the rank holds.  Every rank routes every token with the
replicated router and computes the same global rows and ``keep``; a
pair whose expert another rank holds goes to the discard row, so the
rank's buffer is ``[E/tp * C + 1, D]`` and its batched products run over
its own experts.  Its gate-weighted sum is a partial output, to which
the shared experts' row-parallel partial is added; ONE ``all_reduce``
sums both over the ranks.  Without a plan the block runs the same ops
as the reference's layout, and that ``all_reduce`` returns its input.
For training, the tokens enter the rank's experts and shared slice
through ``sharding.copy_to_model``, and so do the gate weights: each
rank's gates weight its own experts' outputs only, so their gradient
(and the router's behind it) is a partial that the copy sums.  The
router itself reads the replicated input as it is.

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

from repro_torch.distributed import fsdp, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_mlp_params, mlp_partial, normal_


def make_moe_params(gen, cfg: ModelConfig) -> dict:
    """Router ``[D, E]`` and the experts' stacked gated MLPs ``[E, D, F]``
    / ``[E, F, D]``, drawn in the reference's order (router, gate, up,
    down, then the shared experts' MLP).  A rank's configuration gives
    the shapes of its shard: the experts of its ``expert_range`` and its
    slice of the shared width."""
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    first, end = cfg.expert_range
    El = end - first
    p = {"router": normal_(gen, (D, E), scale=1.0 / math.sqrt(D)),
         "experts": {"w_gate": normal_(gen, (El, D, Fd)),
                     "w_up": normal_(gen, (El, D, Fd)),
                     "w_down": normal_(gen, (El, Fd, D))}}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp_params(gen, D, cfg.shared_width)
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


def local_rows(row: torch.Tensor, keep: torch.Tensor, gate_idx: torch.Tensor,
               cfg: ModelConfig, capacity: int) -> tuple:
    """A rank's rows of the global dispatch: the kept pairs whose expert
    lies in ``cfg.expert_range`` keep their row, shifted to the rank's
    buffer; every other pair takes the rank's discard row ``E_local *
    C``.  Returns (row, mine) like :func:`dispatch`'s (row, keep); on one
    device, the inputs themselves."""
    first, end = cfg.expert_range
    if (first, end) == (0, cfg.n_experts):
        return row, keep
    flat = gate_idx.reshape(-1)
    mine = keep & (flat >= first) & (flat < end)
    return torch.where(mine, row - first * capacity,
                       torch.full_like(row, (end - first) * capacity)), mine


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] (see the module doc for a plan)."""
    B, S, D = x.shape
    K = cfg.top_k
    first, end = cfg.expert_range
    El = end - first
    T = B * S
    C = expert_capacity(T, cfg)
    xf = x.reshape(T, D)
    gate_w, gate_idx = route(p, xf, cfg)
    row, keep = dispatch(gate_idx, cfg, C)
    for calls in _watches:
        calls.append((S, gate_idx, keep))
    row, mine = local_rows(row, keep, gate_idx, cfg, C)

    # scatter: each row of the [El, C, D] buffer this rank's kept pairs
    # reach receives one token row
    xc = sharding.copy_to_model(x)
    buf = x.new_zeros((El * C + 1, D))
    buf.index_copy_(0, row, xc.reshape(T, D).repeat_interleave(K, dim=0))
    h = buf[:El * C].view(El, C, D)

    ex = p["experts"]
    g, u = torch.bmm(h, ex["w_gate"]), torch.bmm(h, ex["w_up"])
    a = F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")
    out = torch.bmm(a * u, ex["w_down"]).view(El * C, D)

    # gather back, zero the dropped (and other ranks') pairs, combine
    # with the gate weights
    safe = torch.where(mine, row, torch.zeros_like(row))
    gathered = out[safe].masked_fill(~mine[:, None], 0)
    gate_w = sharding.copy_to_model(gate_w)
    y = (gathered.view(T, K, D) * gate_w[..., None].to(x.dtype)).sum(dim=1)
    y = y.view(B, S, D)
    if "shared" in p:
        y = y + mlp_partial(p["shared"], xc, cfg.act)
    return sharding.all_reduce(y)



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
    if not fsdp.batch_split():
        frac = F.one_hot(idx, E).float().mean(dim=(0, 1))
        return E * (frac * probs.mean(dim=0)).sum()
    # a data-parallel rank's rows: the global batch's fractions and mean
    # probabilities (the ranks' counts and sums added, distributed.fsdp)
    n = fsdp.batch_sum(torch.tensor(float(B * S), device=x.device))
    frac = fsdp.batch_sum(F.one_hot(idx, E).float().sum(dim=(0, 1)))
    frac = frac / (n * cfg.top_k)
    return E * (frac * fsdp.batch_sum(probs.sum(dim=0)) / n).sum()
