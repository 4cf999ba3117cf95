#!/usr/bin/env python3
"""Does an MLA decode row's value depend on the batch it rides in?

    python3 tools/torch_mla_batch_bits.py        # on a CUDA card

At deepseek-v3-671b's widths (one layer of random MLA weights, bf16; 8
sequences of lengths 8 to 499 in a 512-row cache), each stage of one
decode call computed with batched products (the reference's einsums over
the whole batch) for all 8 sequences, then for the same sequences in
groups of 1 and of 2: the line reports how many groups differ from the
8-sequence batch bit for bit, per stage.  Then the port's
``mla_attention_block`` (which runs its fp32 products one sequence at a
time in decode) over a paged arena at 8 sequences against a dense cache
in groups of 1 and 2.  Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def batched_stages(p, x, lat, kr, pos, H=128, dn=128, dr=64, dv=128):
    """The decode call's stages with batched einsums: ``{stage: tensor}``."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import rope
    B, T = x.shape[0], lat.shape[1]
    st = {"x@wq_a": x @ p["wq_a"]}
    q = ops.rmsnorm(st["x@wq_a"], p["q_a_norm"], 1e-6) @ p["wq_b"]
    st["q_lat@wq_b"] = q
    q = q.reshape(B, 1, H, dn + dr)
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], pos[:, None])
    st["lat@wkv_b"] = kvb = (lat @ p["wkv_b"]).reshape(B, T, H, dn + dv)
    k_nope, v = kvb[..., :dn], kvb[..., dn:]
    st["scores_nope"] = torch.einsum("bshd,bthd->bsht", q_nope.float(),
                                     k_nope.float())
    st["scores_rope"] = torch.einsum("bshd,btd->bsht", q_rope.float(), kr.float())
    scores = (st["scores_nope"] + st["scores_rope"]) / math.sqrt(dn + dr)
    mask = torch.arange(T, device=x.device)[None, None, None, :] <= pos[:, None, None, None]
    probs = torch.softmax(scores.masked_fill(~mask, torch.finfo(torch.float32).min), -1)
    st["probs"] = probs
    st["probs@v"] = out = torch.einsum("bsht,bthd->bshd", probs, v.float())
    st["out@wo"] = out.to(x.dtype).reshape(B, 1, H * dv) @ p["wo"]
    return st


@torch.no_grad()
def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mla_batch_bits.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.models import mla
    from repro_torch.models.layers import ParamDraw
    from repro_torch.models.registry import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config("deepseek-v3-671b").replace(n_layers=1)
    p = {k: v.to(dev, torch.bfloat16)
         for k, v in mla.make_mla_params(ParamDraw(0, dev, torch.bfloat16), cfg).items()}
    B, PS, NB = 8, 8, 64
    T = NB * PS
    g = torch.Generator().manual_seed(1)
    lat = torch.randn(B, T, cfg.kv_lora_rank, generator=g).to(dev, torch.bfloat16)
    kr = torch.randn(B, T, cfg.qk_rope_dim, generator=g).to(dev, torch.bfloat16)
    x = torch.randn(B, 1, cfg.d_model, generator=g).to(dev, torch.bfloat16)
    pos = torch.tensor([100, 37, 250, 499, 8, 311, 64, 177], device=dev)
    full = batched_stages(p, x, lat, kr, pos)
    out = {}
    for nb in (1, 2):
        diff = dict.fromkeys(full, 0)
        for b0 in range(0, B, nb):
            part = batched_stages(p, x[b0:b0 + nb], lat[b0:b0 + nb], kr[b0:b0 + nb],
                                  pos[b0:b0 + nb])
            for k in full:
                diff[k] += int(not torch.equal(part[k], full[k][b0:b0 + nb]))
        out[f"batched_groups_of_{nb}_differing_from_8"] = diff

    pt = (torch.randperm(B * NB, generator=g) + 1).reshape(B, NB).int().to(dev)
    arena = {"c_kv": torch.zeros(1 + B * NB, PS, cfg.kv_lora_rank, device=dev,
                                 dtype=torch.bfloat16),
             "k_rope": torch.zeros(1 + B * NB, PS, cfg.qk_rope_dim, device=dev,
                                   dtype=torch.bfloat16)}
    for b in range(B):
        arena["c_kv"][pt[b].long()] = lat[b].reshape(NB, PS, -1)
        arena["k_rope"][pt[b].long()] = kr[b].reshape(NB, PS, -1)
    pos32 = pos.int()
    y8, _ = mla.mla_attention_block(p, x, cfg, pos32[:, None], arena, pos32, pt, PS)
    for nb in (1, 2):
        same = 0
        for b0 in range(0, B, nb):
            c = {"c_kv": lat[b0:b0 + nb].clone(), "k_rope": kr[b0:b0 + nb].clone()}
            y, _ = mla.mla_attention_block(p, x[b0:b0 + nb], cfg,
                                           pos32[b0:b0 + nb, None], c, pos32[b0:b0 + nb])
            same += int(torch.equal(y, y8[b0:b0 + nb]))
        out[f"port_dense_groups_of_{nb}_equal_to_paged_8"] = f"{same}/{B // nb}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out["device"] = smi.stdout.strip() or torch.cuda.get_device_name(0)
    print(json.dumps({"mla_batch_bits": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
