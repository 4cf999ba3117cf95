"""The train step and the fault-tolerant train loop (the port's copy of
``repro.train.train_loop``).

``make_train_step`` gives ``train_step(state, batch) -> (state,
metrics)``: the loss of the model's training forward, its gradients by
``torch.autograd`` (on a card through the flash-attention and rmsnorm
backward kernels), then one AdamW update.  ``train`` resumes from the
newest checkpoint, the data stream's position included, and saves every
``ckpt_every`` steps.  The reference draws its parameters from
``PRNGKey(0)``; the port draws them from ``seed``
(``models.layers.ParamDraw``), so the two start from other weights
unless a caller carries them across (``convert.params_from_jax``).

Under a training plan (a model built with ``sharding.training_plan``;
``distributed.spawn`` starts the ranks and every rank runs this loop)
the step takes the rank's rows of the global batch
(``data.pipeline.shard_rows``), its gradients are its pieces' (the FSDP
gathers' backward reduce-scatters and averages them,
``distributed.fsdp``), the optimizer reads the plan's layout, the
``loss`` metric is the global batch's, and each rank checkpoints its own
pieces with the stream's position under ``rank<k>/`` of the directory.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.data.pipeline import DataConfig, TokenStream, shard_rows
from repro_torch.distributed import fsdp
from repro_torch.models.registry import Model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)
from repro_torch.utils import named_leaves, unflatten_like


def make_train_step(model: Model, opt_cfg: OptimizerConfig,
                    seq_parallel: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``state``
    is ``{'params', 'opt'}``, ``batch`` the stream's ``{'tokens',
    'labels'}`` (and ``frames`` for enc-dec) as numpy or tensors, and
    ``metrics`` ``{'loss', 'grad_norm', 'lr'}`` as 0-d tensors.
    ``seq_parallel`` (the reference's sequence-sharded batch) raises: its
    attention would have to run across sequence shards."""
    if seq_parallel:
        raise NotImplementedError(
            "a sequence-parallel train step (the batch's sequence axis over "
            "'model') needs attention across sequence shards: ROADMAP "
            "Queue 1, item 10")

    plan, layout = model.plan, model.layout

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if plan is not None:
            batch = shard_rows(batch, plan.data_rank, plan.data)
        leaves = [t for _, t in named_leaves(params)]
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        if layout is not None:
            layout.end_step()
        new_params, new_opt, metrics = adamw_update(
            params, unflatten_like(params, iter(grads)), state["opt"], opt_cfg,
            layout)
        metrics = dict(metrics, loss=fsdp.batch_mean(loss.detach(), layout))
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_train_state(model: Model, opt_cfg: OptimizerConfig,
                     seed: int = 0, draw_on_device: bool = False) -> dict:
    """Parameters from ``seed`` and zeroed optimizer state.  By default
    the parameters are drawn on the host, so a seed gives the same weights
    on every device; ``draw_on_device`` draws them on the model's device
    (``layers.ParamDraw``: other weights than the host's for the same
    seed), as a card run of a large model does (a host draw of
    zamba2-2.7b's 2.4 B fp32 parameters takes tens of seconds)."""
    params = model.init_params(seed, draw_on_device=draw_on_device)
    return {"params": params,
            "opt": init_opt_state(params, opt_cfg, model.layout)}


def checkpoint_dir(model: Model, directory: str) -> str:
    """Where a rank keeps its checkpoints: ``directory`` on one device,
    ``directory/rank<k>`` under a plan (``k`` its index on the grid)."""
    if model.plan is None:
        return directory
    import os
    return os.path.join(directory, f"rank{model.plan.world_rank}")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    keep: int = 3


def train(model: Model, opt_cfg: OptimizerConfig, data_cfg: DataConfig,
          loop_cfg: TrainLoopConfig, log: Callable[[str], None] = print,
          seed: int = 0, on_step: Optional[Callable] = None,
          draw_on_device: bool = False):
    """Fault-tolerant training: resumes from the newest checkpoint in
    ``loop_cfg.ckpt_dir`` if there is one.  Returns (state, losses), the
    losses of the steps this call ran.  ``on_step(step, metrics)``, when
    given, is called after every step (timing).  ``seed`` and
    ``draw_on_device``: :func:`init_train_state`."""
    stream = TokenStream(data_cfg)
    state = init_train_state(model, opt_cfg, seed, draw_on_device)
    start_step = 0
    ckpt_dir = loop_cfg.ckpt_dir and checkpoint_dir(model, loop_cfg.ckpt_dir)
    if ckpt_dir:
        try:
            state, start_step, extra = ckpt_lib.restore_checkpoint(
                ckpt_dir, state)
            stream.restore(extra["data"])
            log(f"resumed from step {start_step}")
        except FileNotFoundError:
            pass

    step_fn = make_train_step(model, opt_cfg)
    it = iter(stream)
    losses = []
    for step in range(start_step, loop_cfg.total_steps):
        batch = next(it)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step + 1, metrics)
        if (step + 1) % loop_cfg.log_every == 0:
            log(f"step {step + 1} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f}")
        if ckpt_dir and (step + 1) % loop_cfg.ckpt_every == 0:
            ckpt_lib.save_checkpoint(ckpt_dir, step + 1, state,
                                     extra={"data": stream.state()},
                                     keep=loop_cfg.keep)
    return state, losses
