#!/usr/bin/env python3
"""How far a faulty tensor-parallel run's logits land from one rank's,
beside the bound ``chip_smoke.py`` holds the sound run to.

    python3 tools/torch_tp_fault_gap.py [--layers N]

llama3-8b at full width in bf16 (32 layers unless ``--layers``), its
weights drawn on the card from ``chip_smoke.py``'s seed, prefills
``chip_smoke.py``'s first tensor-parallel prompt (96 tokens) once in one
process (``tp = 1``) and then in two gloo ranks sharing the card: sound,
and with each planted fault in turn (planted at run time, undone after):

  * ``skip_first_reduce``: the ``all_reduce`` after layer 0's attention
    skipped on every rank;
  * ``skip_last_reduce``: the ``all_reduce`` after the last layer's MLP
    skipped on every rank;
  * ``kv_heads_swapped``: rank 1's first two KV heads swapped in every
    layer's ``wk`` and ``wv`` (a mis-sliced KV shard).

Prints one JSON line: per run the largest |logit| gap to ``tp = 1`` as a
share of the largest |logit| (``chip_smoke.py``'s ``logit_gap_of_max``)
and whether the argmax agrees, beside the card's name and power limit
and the bound.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.distributed import sharding, spawn  # noqa: E402
from repro_torch.distributed.group import current_group, mirrored  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402

FAULTS = ("skip_first_reduce", "skip_last_reduce", "kv_heads_swapped")
_ALL_REDUCE = sharding.all_reduce


def _model(layers: int):
    group = current_group()
    cfg = get_config(chip_smoke.TP_ARCH).replace(n_layers=layers)
    return get_model(cfg, device=group.device, plan=group.plan)


def _draw(layers: int) -> dict:
    """Every rank: its shard of the weights, drawn on the card."""
    return _model(layers).init_params(chip_smoke.TP_SEED, draw_on_device=True)


def _skipping(index: int):
    """``sharding.all_reduce`` with its ``index``-th call of a prefill
    (two per layer: attention, then MLP) left out."""
    calls = [0]

    def all_reduce(x):
        calls[0] += 1
        return x if calls[0] - 1 == index else _ALL_REDUCE(x)
    return all_reduce


@mirrored()
def _plant(fault, params: dict, layers: int) -> None:
    """Plant ``fault`` on every rank (None: undo them all)."""
    sharding.all_reduce = {"skip_first_reduce": _skipping(0),
                           "skip_last_reduce": _skipping(2 * layers - 1),
                           }.get(fault, _ALL_REDUCE)
    if fault == "kv_heads_swapped" and current_group().rank == 1:
        hd = get_config(chip_smoke.TP_ARCH).head_dim
        for layer in params["layers"]:
            for name in ("wk", "wv"):
                w = layer["attn"][name].view(layer["attn"][name].shape[0],
                                             -1, hd)
                w[:, [0, 1]] = w[:, [1, 0]]


def _rank(group, layers: int, prompt: np.ndarray):
    if not group.is_controller:
        group.serve()
        return None
    model = _model(layers)
    params = group.build(_draw, layers)
    out = {}
    for fault in (None,) + (FAULTS if group.size > 1 else ()):
        _plant(fault, params, layers)
        logits, _ = model.prefill(params, {"tokens": prompt[None]},
                                  model.make_cache(1, 128))
        out[fault or "sound"] = logits.float().cpu().numpy()[0]
        if fault == "kv_heads_swapped":
            _plant(fault, params, layers)      # the swap undoes itself
        _plant(None, params, layers)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int,
                    default=get_config(chip_smoke.TP_ARCH).n_layers)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_tp_fault_gap.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cfg = get_config(chip_smoke.TP_ARCH)
    _, reqs = chip_smoke.tp_requests(cfg.vocab_size)
    prompt = reqs[0][1]
    runs = {tp: spawn(_rank, tp, (args.layers, prompt),
                      backend=chip_smoke.TP_BACKEND, device="cuda",
                      timeout_s=900)
            for tp in (1, chip_smoke.TP)}
    ref = runs[1]["sound"]
    gaps = {name: {"logit_gap_of_max": float(np.abs(got - ref).max()
                                             / np.abs(ref).max()),
                   "argmax_equal": bool(got.argmax() == ref.argmax())}
            for name, got in runs[chip_smoke.TP].items()}
    print(json.dumps({"tp_fault_gap": {
        "card": card, "note": f"{chip_smoke.TP} ranks sharing one card",
        "arch": chip_smoke.TP_ARCH, "layers": args.layers, "dtype": cfg.dtype,
        "bound": chip_smoke.TP_BF16_LOGIT_BOUND, "runs": gaps}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
