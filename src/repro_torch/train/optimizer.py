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

Under a training plan each rank updates its own pieces (the update is
elementwise) and reads the rest from a ``distributed.fsdp.Layout``: the
global norm adds every rank's squares in one ``all_reduce``, each leaf
counted once (a piece that ``copies`` ranks hold alike is divided by
``copies``, and the columns of a 'model' dimension that some ranks hold
alike by their share, ``Layout.model_weights``), and a factored leaf's
row and column means add the pieces of a split axis over the ranks that
hold them.  Which leaves factor is read from the whole leaf's shape, as
on one device.
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


def init_opt_state(params, cfg: OptimizerConfig, layout=None) -> dict:
    """Zeroed ``m`` and ``v`` beside every parameter (in ``state_dtype``
    when set; a factored ``v`` is fp32 rows and columns) and ``step`` 0;
    under a plan's ``layout`` beside every piece."""
    dt = _STATE_DTYPES[cfg.state_dtype] if cfg.state_dtype else None
    device = next(t for _, t in named_leaves(params)).device

    def m_of(p):
        return torch.zeros(p.shape, dtype=dt or p.dtype, device=p.device)

    def v_of(path, p):
        shape = (p.shape if layout is None
                 else layout.global_shape(path, tuple(p.shape)))
        if _is_factorable(shape, cfg):
            return {"row": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                       device=p.device),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                       dtype=torch.float32, device=p.device)}
        return m_of(p)

    return {"m": map_with_path(lambda _, p: m_of(p), params),
            "v": map_with_path(v_of, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _lr_at(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32; under a plan's
    ``layout`` over every rank's pieces, each leaf counted once."""
    if layout is None:
        return torch.sqrt(sum(t.float().square().sum()
                              for _, t in named_leaves(tree)))
    total = sum(_weighted(t.float().square(), layout, path).sum()
                / layout.copies(path) for path, t in named_leaves(tree))
    return torch.sqrt(_sum_over(total.reshape(1), layout.world)[0])


def _weighted(x: torch.Tensor, layout, path: str,
              dim: Optional[int] = None, axis: int = -1) -> torch.Tensor:
    """``x`` with the elements of a leaf's 'model' dimension that several
    ranks hold alike weighted by their share (``Layout.model_weights``),
    so a sum over the ranks counts them once: ``x`` is the leaf's square
    (``dim`` None) or a statistic whose ``axis`` is the leaf's dimension
    ``dim``, weighted only when that is the 'model' one."""
    mw = None if layout is None else layout.model_weights(path)
    if mw is None:
        return x
    d, w = mw
    if dim is None:
        axis = d
    elif dim != d:
        return x
    shape = [1] * x.dim()
    shape[axis] = -1
    return x * w.to(x.device).reshape(shape)


def _sum_over(t: torch.Tensor, axis) -> torch.Tensor:
    from repro_torch.distributed import fsdp
    return fsdp.all_reduce(t.contiguous(), axis) if axis.n > 1 else t


def _mean(x: torch.Tensor, dim: int, size: int, axis) -> torch.Tensor:
    """The mean over ``dim`` of a whole axis of ``size`` whose other
    pieces ``axis``'s ranks hold (None: all of it here)."""
    if axis is None:
        return x.mean(dim=dim)
    return _sum_over(x.sum(dim=dim), axis) / size


def _leaves_like(tree, like) -> list:
    """The leaves of ``tree`` in the order of ``like``'s leaves, a factored
    ``{'row', 'col'}`` dict kept whole where ``like`` has a tensor."""
    if isinstance(like, dict):
        return [x for k in like for x in _leaves_like(tree[k], like[k])]
    if isinstance(like, list):
        return [x for i, v in enumerate(like) for x in _leaves_like(tree[i], v)]
    return [tree]


@torch.no_grad()
def adamw_update(params, grads, opt_state: dict, cfg: OptimizerConfig,
                 layout=None):
    """One AdamW step: global-norm clip, linear warmup, bias correction,
    decoupled weight decay.  Returns (new_params, new_opt_state,
    {'grad_norm', 'lr'}), as ``repro.train.optimizer.adamw_update``;
    under a plan's ``layout`` over this rank's pieces (module doc)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, layout)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _lr_at(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    def upd(path, p, g, m, v):
        g = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g
        mhat = m_new / bc1
        if isinstance(v, dict):           # factored second moment
            g2 = g.square() + 1e-30
            nd = g2.dim()
            split = {} if layout is None else layout.split_dims(path)
            shape = g2.shape if layout is None else layout.global_shape(
                path, tuple(g2.shape))
            last, second = split.get(nd - 1), split.get(nd - 2)
            row = b2 * v["row"] + (1 - b2) * _mean(
                _weighted(g2, layout, path, nd - 1, -1), -1, shape[-1], last)
            col = b2 * v["col"] + (1 - b2) * _mean(
                _weighted(g2, layout, path, nd - 2, -2), -2, shape[-2], second)
            # rank-1 reconstruction: v ~ row x col / mean(row)
            denom = torch.clamp(_mean(_weighted(row, layout, path, nd - 2, -1),
                                      -1, shape[-2], second)[..., None],
                                min=1e-30)
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

    paths = [path for path, _ in named_leaves(params)]
    p_flat = _leaves_like(params, params)
    out = [upd(path, p, g, m, v) for path, p, g, m, v in zip(
        paths, p_flat, _leaves_like(grads, params),
        _leaves_like(opt_state["m"], params),
        _leaves_like(opt_state["v"], params))]
    new_params = unflatten_like(params, iter(o[0] for o in out))
    new_m = unflatten_like(params, iter(o[1] for o in out))
    new_v = unflatten_like(params, iter(o[2] for o in out))
    return (new_params, {"m": new_m, "v": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})
