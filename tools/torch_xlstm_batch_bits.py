#!/usr/bin/env python3
"""Does an xLSTM sequence's value depend on the batch it rides in?

    python3 tools/torch_xlstm_batch_bits.py        # on a CUDA card

At xlstm-1.3b's widths (one unit of random weights: 7 mLSTM blocks and 1
sLSTM block, bf16), ``transformer.xlstm_unit`` runs a 256-token prefill
of 8 sequences, then one decode step of the 8 sequences from the batched
prefill's state, each once as a batch of 8 and once one sequence at a
time.  Every product and scan the unit runs (``@``, ``torch.einsum``,
``torch.cumsum``) is recorded in call order; per operation (the same
equation at every layer, chunk and time step counted together) the line
reports how many calls had a sequence whose bits differ between the
batch and alone, and the most sequences one call had differ; the first
such call is named (later ones may only inherit its difference).  Then
the unit's output and state leaves.  Prints one JSON line with the card's
name and power limit.
"""

from __future__ import annotations

import collections
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


@contextlib.contextmanager
def recording(log: list):
    """Append ``(label, output)`` of every ``@``, ``torch.einsum`` and
    ``torch.cumsum`` call to ``log``."""
    einsum, cumsum, matmul = torch.einsum, torch.cumsum, torch.Tensor.__matmul__

    def rec_einsum(eq, *ops):
        out = einsum(eq, *ops)
        log.append((f"einsum {eq}", out))
        return out

    def rec_cumsum(t, dim, **kw):
        out = cumsum(t, dim, **kw)
        log.append((f"cumsum dim {dim}", out))
        return out

    def rec_matmul(a, b):
        out = matmul(a, b)
        log.append((f"matmul [..., {a.shape[-1]}] @ {tuple(b.shape)}", out))
        return out

    torch.einsum, torch.cumsum, torch.Tensor.__matmul__ = (
        rec_einsum, rec_cumsum, rec_matmul)
    try:
        yield
    finally:
        torch.einsum, torch.cumsum, torch.Tensor.__matmul__ = einsum, cumsum, matmul


def compare(batched: list, alone: list) -> tuple:
    """``{label: {"calls", "calls_differing", "max_sequences_differing"}}``
    over the calls of one batched run and the per-sequence runs, and the
    first call (in call order) with a sequence that differs."""
    out: dict = collections.OrderedDict()
    first = None
    for i, (label, t) in enumerate(batched):
        diff = 0
        for b, log in enumerate(alone):
            lab, a = log[i]
            assert lab == label, (lab, label)
            diff += not torch.equal(t[b:b + 1], a)
        if diff and first is None:
            first = {"call": i, "op": label, "sequences_differing": diff}
        row = out.setdefault(label, {"calls": 0, "calls_differing": 0,
                                     "max_sequences_differing": 0})
        row["calls"] += 1
        row["calls_differing"] += diff > 0
        row["max_sequences_differing"] = max(row["max_sequences_differing"], diff)
    return out, first


def run_unit(params, cfg, x, cache) -> tuple:
    from repro_torch.models import transformer
    log: list = []
    with torch.no_grad(), recording(log):
        y = transformer.xlstm_unit(params["mlstm"].__getitem__,
                                   params["slstm"].__getitem__, x, cfg, cache, 0)
    torch.cuda.synchronize()
    return y, log


def slot(cache: dict, b: int) -> dict:
    return {g: {k: t[:, b:b + 1].clone() for k, t in sub.items()}
            for g, sub in cache.items()}


def leaves_differing(batched: dict, alone: list) -> dict:
    return {f"{g}.{k}": sum(not torch.equal(t[:, b:b + 1], alone[b][g][k])
                            for b in range(len(alone)))
            for g, sub in batched.items() for k, t in sub.items()}


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        print("torch_xlstm_batch_bits.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.models.registry import get_config, get_model
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cfg = get_config("xlstm-1.3b").replace(n_layers=8)        # one unit
    model = get_model(cfg, device="cuda")
    params = model.init_params(seed=0)
    gen = torch.Generator().manual_seed(1)
    B, S = 8, 256
    x = (torch.randn((B, S, cfg.d_model), generator=gen) * 0.5).to(
        "cuda", model.dtype)
    out = {"card": smi, "config": f"{cfg.name}, one unit (7 mLSTM + 1 sLSTM), "
                                  f"{cfg.dtype}", "batch": B, "prompt_len": S}
    for step in ("prefill", "decode"):
        if step == "prefill":
            cache = model.make_cache(B, S)
            caches = [model.make_cache(1, S) for _ in range(B)]
            xs = x
        else:
            cache = prefilled
            caches = [slot(prefilled, b) for b in range(B)]
            xs = x[:, -1:]
        y, log = run_unit(params, cfg, xs, cache)
        alone = [run_unit(params, cfg, xs[b:b + 1], caches[b]) for b in range(B)]
        ops, first = compare(log, [lg for _, lg in alone])
        out[step] = {
            "first_differing": first, "ops": ops,
            "output_sequences_differing": sum(
                not torch.equal(y[b:b + 1], alone[b][0]) for b in range(B)),
            "state_sequences_differing": leaves_differing(cache, caches)}
        if step == "prefill":
            prefilled = {g: {k: t.clone() for k, t in sub.items()}
                         for g, sub in cache.items()}
    print(json.dumps({"xlstm_batch_bits": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
