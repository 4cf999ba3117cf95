"""AdamW with global-norm clipping over the port's parameter tree (the
port's copy of ``repro.train.optimizer``, same arithmetic).

The tree is a nested dict / list of tensors (``models.transformer``'s
parameters); the optimizer state mirrors it: ``m`` and ``v`` leaf for
leaf, ``v`` a ``{'row', 'col'}`` dict for a factored leaf, and ``step``
a 0-d int32 tensor.  The update is functional (new tensors, as the
reference returns new arrays), one leaf at a time.  It is plain tensor
arithmetic on every device: the reference's optimizer is XLA, not a
Pallas kernel.  ``torch.optim.AdamW`` is not used: it has neither the
global-norm clip nor the factored second moment.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.utils import map_with_path, named_leaves, unflatten_like

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Optional[str] = None    # None -> the parameters' dtype
    warmup_steps: int = 100
    # Adafactor-style factored second moment for leaves of >= 2 axes whose
    # last two are both >= min_factored_size: v kept as a (row, col)
    # outer-product estimate over the trailing two axes
    factored: bool = False
    min_factored_size: int = 128


def _is_factorable(shape, cfg: OptimizerConfig) -> bool:
    return (cfg.factored and len(shape) >= 2
            and shape[-1] >= cfg.min_factored_size
            and shape[-2] >= cfg.min_factored_size)


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    """Zeroed ``m`` and ``v`` beside every parameter (in ``state_dtype``
    when set; a factored ``v`` is fp32 rows and columns) and ``step`` 0."""
    dt = _STATE_DTYPES[cfg.state_dtype] if cfg.state_dtype else None
    device = next(t for _, t in named_leaves(params)).device

    def m_of(p):
        return torch.zeros(p.shape, dtype=dt or p.dtype, device=p.device)

    def v_of(p):
        if _is_factorable(p.shape, cfg):
            return {"row": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                       device=p.device),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                       dtype=torch.float32, device=p.device)}
        return m_of(p)

    return {"m": map_with_path(lambda _, p: m_of(p), params),
            "v": map_with_path(lambda _, p: v_of(p), params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _lr_at(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.sqrt(sum(t.float().square().sum() for _, t in named_leaves(tree)))


def _leaves_like(tree, like) -> list:
    """The leaves of ``tree`` in the order of ``like``'s leaves, a factored
    ``{'row', 'col'}`` dict kept whole where ``like`` has a tensor."""
    if isinstance(like, dict):
        return [x for k in like for x in _leaves_like(tree[k], like[k])]
    if isinstance(like, list):
        return [x for i, v in enumerate(like) for x in _leaves_like(tree[i], v)]
    return [tree]


@torch.no_grad()
def adamw_update(params, grads, opt_state: dict, cfg: OptimizerConfig):
    """One AdamW step: global-norm clip, linear warmup, bias correction,
    decoupled weight decay.  Returns (new_params, new_opt_state,
    {'grad_norm', 'lr'}), as ``repro.train.optimizer.adamw_update``."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _lr_at(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g
        mhat = m_new / bc1
        if isinstance(v, dict):           # factored second moment
            g2 = g.square() + 1e-30
            row = b2 * v["row"] + (1 - b2) * g2.mean(dim=-1)
            col = b2 * v["col"] + (1 - b2) * g2.mean(dim=-2)
            # rank-1 reconstruction: v ~ row x col / mean(row)
            denom = torch.clamp(row.mean(dim=-1, keepdim=True), min=1e-30)
            vhat = (row[..., :, None] * col[..., None, :]
                    / denom[..., None]) / bc2
            v_new = {"row": row, "col": col}
        else:
            v_full = b2 * v.float() + (1 - b2) * g.square()
            vhat = v_full / bc2
            v_new = v_full.to(v.dtype)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new

    p_flat = _leaves_like(params, params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        p_flat, _leaves_like(grads, params), _leaves_like(opt_state["m"], params),
        _leaves_like(opt_state["v"], params))]
    new_params = unflatten_like(params, iter(o[0] for o in out))
    new_m = unflatten_like(params, iter(o[1] for o in out))
    new_v = unflatten_like(params, iter(o[2] for o in out))
    return (new_params, {"m": new_m, "v": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})
