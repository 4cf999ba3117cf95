"""Training CLI: any ported arch through the fault-tolerant loop (the
port's ``repro.launch.train``, the same flags and ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 100 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --steps 10                                  # on a card

Without ``--smoke`` the full configuration of ``--arch`` trains in
float32, as the reference's CLI trains it; ``--smoke`` takes the reduced
configuration.  The model lives on ``--device``: ``cuda`` by default,
which raises without a card, or ``cpu`` when asked.  On the card the
forward runs the flash-attention, rmsnorm and ``ssd_scan`` kernels and
the backward their backward kernels (fp32), so every family trains
there (zamba2-2.7b at full depth: 2.4 B parameters, ~39 GB of fp32
parameters, gradients and moments).  Weights are random from seed 0,
drawn on the model's device (``init_train_state(draw_on_device=)``): a
card run therefore starts from other weights than a ``--device cpu``
run.  The data is ``TokenStream``'s synthetic Zipf stream.  Training under a sharding plan has no flag here, as the
reference's CLI has none: a rank function builds the model under
``group.training_plan`` (``distributed.spawn``).
"""

from __future__ import annotations

import argparse

from repro_torch.data.pipeline import DataConfig
from repro_torch.models.registry import (ARCH_IDS, get_config, get_model,
                                         get_smoke_model)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_loop import TrainLoopConfig, train
from repro_torch.utils import named_leaves


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--factored", action="store_true",
                    help="Adafactor-style factored second moment")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> tuple:
    """(model, optimizer, data and loop configs) of the parsed flags, as
    the reference's CLI builds them."""
    if args.smoke:
        model = get_smoke_model(args.arch, device=args.device)
    else:
        model = get_model(get_config(args.arch).replace(dtype="float32"),
                          device=args.device)
    data = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    opt = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          factored=args.factored)
    loop = TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                           ckpt_dir=args.ckpt_dir, log_every=10)
    return model, opt, data, loop


def main(argv=None) -> None:
    args = parse_args(argv)
    model, opt, data, loop = build(args)
    n = sum(t.numel() for _, t in named_leaves(model.param_specs()))
    print(f"{model.cfg.name}: {n / 1e6:.1f}M params on {model.device}")
    _, losses = train(model, opt, data, loop,
                      draw_on_device=model.device.type != "cpu")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
