#!/usr/bin/env python3
"""Device time of the two decode kernels of a checkout, for an A/B of two.

    python3 tools/torch_decode_kernels_ab.py [ROOT]   # ROOT: a checkout (default: this one)

Builds the kernels of the checkout at ROOT and times, with ROOT's
``chip_smoke.time_ms`` (CUDA-graph replay between events), its
``decode_attention`` and ``paged_decode_attention`` at ``chip_smoke.py``'s
serving shapes: B = 8 sequences of seeded ragged lengths up to 512 (and
one 4,096-row sequence) at smollm-135m's, llama3-8b's, gemma-2b's and
zamba2-2.7b's heads, bf16 and fp32, and the int8 arena.  The inputs come
from this script's own seed, so two checkouts see the same tensors.
Prints the card's name and power limit, then one JSON line of µs per case.

Kernel times move with the card and its neighbours, so run two checkouts
in turns in fresh processes (parent, change, change, parent) within one
call and compare there.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HEADS = {"smollm": dict(H=9, KV=3, d=64), "llama3-8b": dict(H=32, KV=8, d=128),
         "gemma-2b": dict(H=8, KV=1, d=256), "zamba2-2.7b": dict(H=32, KV=32, d=80)}
LENGTHS = [1, 300, 64, 129, 512, 17, 250, 512]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else Path(__file__).resolve().parent.parent).resolve()
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_kernels_ab.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"device: {smi.stdout.strip()}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    out = {"root": str(root)}
    for tag, hd in HEADS.items():
        for dtype in (torch.bfloat16, torch.float32):
            for lengths, T in ((LENGTHS, 512), ([4096], 4096)):
                if T == 4096 and tag not in ("smollm", "llama3-8b"):
                    continue
                B, name = len(lengths), str(dtype)[6:]
                q = torch.randn((B, hd["H"], hd["d"]), generator=gen).to(dev, dtype)
                shape = (B, T, hd["KV"], hd["d"])
                ck = torch.randn(shape, generator=gen).to(dev, dtype)
                cv = torch.randn(shape, generator=gen).to(dev, dtype)
                ln = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
                k, v = ck.transpose(1, 2), cv.transpose(1, 2)
                out[f"decode {tag} B={B} T={T} {name}"] = 1e3 * chip_smoke.time_ms(
                    lambda: decode_attention(q, k, v, ln))
                for int8 in (False, True):
                    if int8 and dtype == torch.float32:
                        continue
                    c = chip_smoke.make_paged_case(gen, B, hd["H"], hd["KV"], hd["d"],
                                                   chip_smoke.PAGE_SIZE, T, lengths,
                                                   dtype, int8, dev)
                    args = (c["q"], c["k_pages"], c["v_pages"], c["page_table"],
                            c["lengths"])
                    kw = {"k_scales": c["k_scales"], "v_scales": c["v_scales"]}
                    kv = "int8" if int8 else name
                    out[f"paged {tag} B={B} T={T} {name}/{kv}"] = 1e3 * (
                        chip_smoke.time_ms(lambda: paged_decode_attention(*args, **kw)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
