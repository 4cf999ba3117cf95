#!/usr/bin/env python3
"""Device time of the rmsnorm and ssd_scan kernels of a checkout, for an A/B of two.

    python3 tools/torch_norm_ssd_ab.py [ROOT]   # ROOT: a checkout (default: this one)

Builds the kernels of the checkout at ROOT and times, with ROOT's
``chip_smoke.time_ms`` (CUDA-graph replay between events), at
``chip_smoke.py``'s shapes:

* ``rmsnorm`` at smollm-135m's decode (8 x 576) and prefill (384 x 576)
  rows, qwen3-14b's head-norm rows (8 x 40 x 128) and llama3-8b's prefill
  rows (384 x 4096), bf16 and fp32, beside ``F.rms_norm``; where the
  checkout has the residual form, also ``rmsnorm(x, scale, residual=r)``
  beside ``x + r; F.rms_norm`` and ``x + r`` then the kernel;
* ``ssd_scan`` at zamba2-2.7b's heads (H = 80, dh = ds = 64, chunk 128):
  B = 1 at S = 64, 128, 200, 384 and 512, and B = 4 at S = 256 with an
  initial state, B and C bf16 (the serving path) and fp32.

Each output is checked against ROOT's plain version (rmsnorm within one
bf16 ulp or 1e-5 relative, ssd_scan within 1e-4 of the largest |y| and
|h|), so a broken kernel fails here too.  The inputs come from this
script's own seed, so two checkouts see the same tensors.  Prints the
card's name and power limit, then one JSON line of µs per case.

Kernel times move with the card and its neighbours, so run two checkouts
in turns in fresh processes (parent, change, change, parent) within one
call and compare there.  Needs a CUDA device.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

NORM_CASES = (("smollm-decode", (8, 1, 576)), ("smollm-prefill", (384, 576)),
              ("qwen3-14b-head", (8, 1, 40, 128)), ("llama3-8b-prefill", (384, 4096)))
SSD_CASES = ((1, 64, False), (1, 128, False), (1, 200, False), (1, 384, False),
             (1, 512, False), (4, 256, True))
SSD = dict(H=80, dh=64, ds=64, Q=128, d_inner=5120)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else Path(__file__).resolve().parent.parent).resolve()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_norm_ssd_ab.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"device: {smi.stdout.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    fused = "residual" in inspect.signature(rmsnorm).parameters
    time_ms = chip_smoke.time_ms
    out = {"root": str(root)}

    for tag, shape in NORM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            name = f"{tag} {str(dtype)[6:]}"
            x = torch.randn(shape, generator=gen).to(dev, dtype)
            r = torch.randn(shape, generator=gen).to(dev, dtype)
            scale = (torch.randn(shape[-1], generator=gen) * 0.1 + 1).to(dev, dtype)
            want = ref.rmsnorm_ref(x, scale, 1e-5).float()
            diff = (rmsnorm(x, scale, 1e-5).float() - want).abs()
            lim = (1e-5 * want.abs() if dtype == torch.float32
                   else chip_smoke.bf16_ulp(want))
            if not bool((diff <= lim).all()):
                raise AssertionError(f"rmsnorm {name}: max error {float(diff.max())}")
            d = shape[-1]
            out[f"rmsnorm {name}"] = 1e3 * time_ms(lambda: rmsnorm(x, scale, 1e-5))
            out[f"F.rms_norm {name}"] = 1e3 * time_ms(
                lambda: F.rms_norm(x, (d,), scale, 1e-5))
            if fused:
                y, s = rmsnorm(x, scale, 1e-5, residual=r)
                if not (torch.equal(s, x + r)
                        and torch.equal(y, rmsnorm(x + r, scale, 1e-5))):
                    raise AssertionError(f"fused rmsnorm {name} differs")
                out[f"rmsnorm[residual] {name}"] = 1e3 * time_ms(
                    lambda: rmsnorm(x, scale, 1e-5, residual=r))
                out[f"add+F.rms_norm {name}"] = 1e3 * time_ms(
                    lambda: F.rms_norm(x + r, (d,), scale, 1e-5))
                out[f"add+rmsnorm {name}"] = 1e3 * time_ms(
                    lambda: rmsnorm(x + r, scale, 1e-5))

    c = SSD
    for B, S, with_h0 in SSD_CASES:
        for bc_dtype in (torch.bfloat16, torch.float32):
            conv = (torch.randn((B, S, c["d_inner"] + 2 * c["ds"]), generator=gen)
                    * 0.5).to(dev, bc_dtype)
            xb = torch.randn((B, S, c["H"], c["dh"]), generator=gen).to(dev)
            ld = (-torch.rand((B, S, c["H"]), generator=gen) * 0.25).to(dev)
            h0 = (torch.randn((B, c["H"], c["dh"], c["ds"]), generator=gen).to(dev)
                  if with_h0 else None)
            Bm = conv[..., c["d_inner"]:c["d_inner"] + c["ds"]]
            Cm = conv[..., c["d_inner"] + c["ds"]:]
            y, h = ssd_scan(xb, Bm, Cm, ld, c["Q"], h0)
            yp, hp = ref.ssd_ref(xb, Bm, Cm, ld, c["Q"], h0)
            for got, want in ((y, yp), (h, hp)):
                err = float((got - want).abs().max())
                if not err <= 1e-4 * float(want.abs().max()):
                    raise AssertionError(f"ssd_scan B={B} S={S}: error {err}")
            out[f"ssd_scan B={B} S={S} h0={with_h0} {str(bc_dtype)[6:]}"] = 1e3 * time_ms(
                lambda: ssd_scan(xb, Bm, Cm, ld, c["Q"], h0))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
