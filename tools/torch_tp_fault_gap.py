#!/usr/bin/env python3
"""How far a faulty tensor-parallel run's logits land from one rank's,
beside the bound ``chip_smoke.py`` holds the sound run to.

    python3 tools/torch_tp_fault_gap.py
        [--case dense|moe|mla|lora|zamba|xlstm ...] [--layers N] [--floor]

Each case is one of phase 15's bf16 models at full width, its weights
drawn on the card from ``chip_smoke.py``'s seed: ``dense`` llama3-8b
(32 layers), ``moe`` phi3.5-moe (4 of 32, expert parallel), ``mla``
deepseek-v3 (1 of 61: MLA by heads over a moe layer with a shared
expert), ``lora`` llama3-8b at phase 15's bf16 depth (8 of 32)
through row 1 of ``chip_smoke.tp_lora_bank`` (wq, wk, wv and wo
adapted), ``zamba`` zamba2-2.7b (12 of 54 Mamba2 blocks, two units of
the shared block) and ``xlstm`` xlstm-1.3b (16 of 48 blocks: two units
of 7 mLSTM and 1 sLSTM); ``--layers`` sets the depth of every case run
(default: all six).  Each prefills ``chip_smoke.py``'s first tensor-parallel prompt
(96 tokens) once in one process (``tp = 1``) and then in two gloo ranks
sharing the card: sound, and with each of its case's planted faults in
turn (planted at run time, undone after):

  * ``skip_first_reduce``: the ``all_reduce`` after layer 0's attention
    skipped on every rank;
  * ``skip_last_reduce``: the ``all_reduce`` after the last layer's MLP
    (moe: experts and shared expert together) skipped on every rank;
  * ``kv_heads_swapped`` (dense): rank 1's first two KV heads swapped in
    every layer's ``wk`` and ``wv`` (a mis-sliced KV shard);
  * ``expert_range_shifted`` (moe, mla): rank 1 reads its expert range
    one expert on (a wrong ``expert_first``): its pairs of its first
    expert are lost and the others meet their neighbour's weights;
  * ``shared_partial_dropped`` (mla): rank 1's shared-expert partial left
    out of the moe layer's sum;
  * ``wkv_b_heads_swapped`` (mla): rank 1's first two heads' columns of
    every layer's ``wkv_b`` swapped (a mis-sliced head shard);
  * ``wo_delta_after_reduce`` (lora): every rank adds its wo delta after
    the layer's ``all_reduce`` instead of before it;
  * ``wq_b_columns_swapped`` (lora): rank 1's first two heads' columns of
    the bank's ``wq`` ``b`` swapped (a mis-sliced adapter shard);
  * ``bank_row_off_by_one`` (lora): rank 1 gathers its adapter rows one
    row on (row 2, another adapter, for row 1);
  * ``slice_normalised_alone`` (zamba, xlstm): every rank normalises its
    slice of each split row (Mamba2's gated norm, the mLSTM's and the
    sLSTM's norms) alone, by its own mean of squares;
  * ``skip_out_proj_reduce`` (zamba, xlstm): the ``all_reduce`` after the
    first block's output projection (Mamba2's ``out_proj``, the mLSTM's
    ``down_proj``) skipped on every rank;
  * ``bc_cut_like_x`` (zamba): each rank keeps only its half of the state
    columns of B and C (the other half zero), as if B and C were cut like
    x instead of kept whole;
  * ``slstm_output_ungathered`` (xlstm): rank 1 keeps its own heads of
    each sLSTM output in place of the gathered row (zeros for rank 0's).

Prints one JSON line: per case and run the largest |logit| gap to
``tp = 1`` as a share of the largest |logit| (``chip_smoke.py``'s
``logit_gap_of_max``) and whether the argmax agrees, beside the card's
name and power limit and the case's bound.  ``--floor`` also prefills
the case in float32 at ``tp = 1`` (the same draw before its cast to
bf16) and gives every run's gap to it, and ``tp = 1``'s own: the bf16
noise a bound must clear.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import moe, ssm  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402

# case: (architecture, depth, its faults)
CASES = {
    "dense": ("llama3-8b", get_config("llama3-8b").n_layers,
              ("skip_first_reduce", "skip_last_reduce", "kv_heads_swapped")),
    "moe": (chip_smoke.PHI_ARCH, 4,
            ("skip_first_reduce", "skip_last_reduce", "expert_range_shifted")),
    "mla": (chip_smoke.DSV3_ARCH, 1,
            ("skip_first_reduce", "skip_last_reduce", "expert_range_shifted",
             "shared_partial_dropped", "wkv_b_heads_swapped")),
    "lora": ("llama3-8b", chip_smoke.TP_BF16_LAYERS,
             ("wo_delta_after_reduce", "wq_b_columns_swapped",
              "bank_row_off_by_one")),
    "zamba": (chip_smoke.ZAMBA_ARCH, 12,
              ("slice_normalised_alone", "skip_out_proj_reduce",
               "bc_cut_like_x")),
    "xlstm": (chip_smoke.XLSTM_ARCH, 16,
              ("slice_normalised_alone", "skip_out_proj_reduce",
               "slstm_output_ungathered")),
}
_ALL_REDUCE = sharding.all_reduce
_GATHER_COLUMNS = sharding.gather_columns
_SPLIT_RMSNORM = ssm.split_rmsnorm
# weights a planted fault zeroes, by (path, leaf), to put back after it
_SAVED: dict = {}
_LOCAL_ROWS = moe.local_rows
_MLP_PARTIAL = moe.mlp_partial
_LORA_DELTA = model_layers.lora_delta


def _model(arch: str, layers: int, dtype=None):
    group = current_group()
    cfg = get_config(arch).replace(n_layers=layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    return get_model(cfg, device=group.device, plan=group.plan)


def _draw(arch: str, layers: int, dtype=None) -> dict:
    """Every rank: its shard of the weights, drawn on the card (float32
    normals, then cast: a float32 model gets the same draw uncast)."""
    return _model(arch, layers, dtype).init_params(chip_smoke.TP_SEED,
                                                   draw_on_device=True)


def _skipping(index: int):
    """``sharding.all_reduce`` with its ``index``-th call of a prefill
    (two per layer: attention, then MLP or moe) left out."""
    calls = [0]

    def all_reduce(x):
        calls[0] += 1
        return x if calls[0] - 1 == index else _ALL_REDUCE(x)
    return all_reduce


def _shifted_rows(row, keep, gate_idx, cfg, capacity):
    """``moe.local_rows`` over an expert range one expert on."""
    return _LOCAL_ROWS(row, keep, gate_idx, dataclasses.replace(
        cfg, expert_first=cfg.expert_first + 1), capacity)


def _delta_after_reduce(d_model: int):
    """``lora_delta`` and ``all_reduce`` with the wo delta (at tp = 2 the
    one slab whose output is ``d_model`` wide) held back from the rank's
    partial and added after the layer's reduce."""
    held = []

    def lora_delta(x, slab, ids):
        d = _LORA_DELTA(x, slab, ids)
        if slab["b"].shape[-1] == d_model:
            held.append(d)
            return torch.zeros_like(d)
        return d

    def all_reduce(x):
        y = _ALL_REDUCE(x)
        return y + held.pop() if held else y
    return lora_delta, all_reduce


def _alone(x, scale, eps=1e-6):
    """The split-row norm without its reduce: the slice's own mean."""
    return ops.rmsnorm(x, scale, eps)


def _ungathered(x):
    """``gather_columns`` run (the collective stays in step) but this
    rank's heads kept in place of the gathered row, zeros elsewhere."""
    full = _GATHER_COLUMNS(x)
    mine = torch.zeros_like(full)
    rank, width = current_group().rank, x.shape[-1]
    mine[..., rank * width:(rank + 1) * width] = x
    return mine


def _cut_bc(params: dict, cfg) -> None:
    """Zero the B and C state columns of every Mamba2 ``in_proj`` outside
    this rank's half (saved first, to put back)."""
    rank, tp = current_group().rank, current_group().size
    d_inner = 2 * (cfg.ssm_expand * cfg.d_model) // tp     # z and x, local
    ds = cfg.ssm_state
    keep = slice(rank * ds // tp, (rank + 1) * ds // tp)
    for i, block in enumerate(params["mamba"]):
        w = block["mixer"]["in_proj"]
        _SAVED[i] = w.clone()
        for first in (d_inner, d_inner + ds):        # B, then C
            cols = w[:, first:first + ds]
            kept = cols[:, keep].clone()
            cols.zero_()
            cols[:, keep] = kept


def _swap_heads(w: torch.Tensor, width: int) -> None:
    """Swap the first two ``width``-column heads of ``w`` in place."""
    v = w.view(w.shape[0], -1, width)
    v[:, [0, 1]] = v[:, [1, 0]]


@mirrored()
def _plant(fault, params: dict, arch: str, layers: int,
           bank: dict | None = None) -> None:
    """Plant ``fault`` on every rank (None: undo them all)."""
    sharding.all_reduce = {"skip_first_reduce": _skipping(0),
                           "skip_last_reduce": _skipping(2 * layers - 1),
                           }.get(fault, _ALL_REDUCE)
    moe.local_rows, moe.mlp_partial = _LOCAL_ROWS, _MLP_PARTIAL
    model_layers.lora_delta = _LORA_DELTA
    ssm.split_rmsnorm, sharding.gather_columns = _SPLIT_RMSNORM, _GATHER_COLUMNS
    for i, w in _SAVED.items():
        params["mamba"][i]["mixer"]["in_proj"].copy_(w)
    _SAVED.clear()
    cfg = get_config(arch)
    if fault == "skip_out_proj_reduce":     # call 0 is block 0's norm sums
        sharding.all_reduce = _skipping(1)
    elif fault == "slice_normalised_alone":
        ssm.split_rmsnorm = _alone
    elif fault == "bc_cut_like_x":
        _cut_bc(params, cfg)
    if fault == "wo_delta_after_reduce":
        model_layers.lora_delta, sharding.all_reduce = _delta_after_reduce(
            cfg.d_model)
    if current_group().rank != 1:
        return
    if fault == "wq_b_columns_swapped":
        b = bank["wq"]["b"]
        v = b.view(*b.shape[:-1], -1, cfg.head_dim)
        v[..., [0, 1], :] = v[..., [1, 0], :]
    elif fault == "bank_row_off_by_one":
        model_layers.lora_delta = (
            lambda x, slab, ids: _LORA_DELTA(x, slab, ids + 1))
    elif fault == "slstm_output_ungathered":
        sharding.gather_columns = _ungathered
    if fault == "expert_range_shifted":
        moe.local_rows = _shifted_rows
    elif fault == "shared_partial_dropped":
        moe.mlp_partial = lambda p, x, act="silu": torch.zeros_like(x)
    elif fault == "kv_heads_swapped":
        for layer in params["layers"]:
            for name in ("wk", "wv"):
                _swap_heads(layer["attn"][name], cfg.head_dim)
    elif fault == "wkv_b_heads_swapped":
        for layer in params["layers"]:
            _swap_heads(layer["attn"]["wkv_b"],
                        cfg.qk_nope_dim + cfg.v_head_dim)


# the faults that change the weights, and undo themselves when planted again
_SELF_UNDOING = ("kv_heads_swapped", "wkv_b_heads_swapped",
                 "wq_b_columns_swapped")


def _rank(group, arch: str, layers: int, faults: tuple, prompt: np.ndarray,
          lora: bool = False, dtype=None):
    if not group.is_controller:
        group.serve()
        return None
    model = _model(arch, layers, dtype)
    params = group.build(_draw, arch, layers, dtype)
    bank = chip_smoke.tp_lora_bank(model) if lora else None
    adapters = {"adapter_bank": bank, "adapter_ids": [1]} if lora else {}
    out = {}
    for fault in (None,) + (faults if group.size > 1 else ()):
        _plant(fault, params, arch, layers, bank)
        logits, _ = model.prefill(params, {"tokens": prompt[None]},
                                  model.make_cache(1, 128), **adapters)
        out[fault or "sound"] = logits.float().cpu().numpy()[0]
        if fault in _SELF_UNDOING:
            _plant(fault, params, arch, layers, bank)
        _plant(None, params, arch, layers, bank)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", action="append", choices=sorted(CASES),
                    help="a case to run (repeatable; default: all)")
    ap.add_argument("--layers", type=int, default=None,
                    help="the depth of every case run (default: its own)")
    ap.add_argument("--floor", action="store_true",
                    help="also every run's gap to a float32 tp = 1 prefill")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_tp_fault_gap.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = {}
    for case in args.case or list(CASES):
        arch, layers, faults = CASES[case]
        layers = args.layers or layers
        cfg = get_config(arch)
        _, reqs = chip_smoke.tp_requests(cfg.vocab_size)
        runs = {tp: spawn(_rank, tp, (arch, layers, faults, reqs[0][1],
                                      case == "lora"),
                          backend=chip_smoke.TP_BACKEND, device="cuda",
                          timeout_s=900)
                for tp in (1, chip_smoke.TP)}
        ref = runs[1]["sound"]
        gaps = {name: {"logit_gap_of_max": float(np.abs(got - ref).max()
                                                 / np.abs(ref).max()),
                       "argmax_equal": bool(got.argmax() == ref.argmax())}
                for name, got in runs[chip_smoke.TP].items()}
        bound = (chip_smoke.TP_LORA_LOGIT_BOUND if case == "lora"
                 else chip_smoke.tp_logit_bound(arch))
        result[case] = {"arch": arch, "layers": layers, "dtype": cfg.dtype,
                        "bound": bound, "runs": gaps}
        if args.floor:
            f32 = spawn(_rank, 1, (arch, layers, (), reqs[0][1],
                                   case == "lora", "float32"),
                        backend=chip_smoke.TP_BACKEND, device="cuda",
                        timeout_s=900)["sound"]
            result[case]["fp32_gap_of_max"] = {
                "tp1": float(np.abs(ref - f32).max() / np.abs(f32).max()),
                **{name: float(np.abs(got - f32).max() / np.abs(f32).max())
                   for name, got in runs[chip_smoke.TP].items()}}
    print(json.dumps({"tp_fault_gap": {
        "card": card, "note": f"{chip_smoke.TP} ranks sharing one card",
        "cases": result}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
