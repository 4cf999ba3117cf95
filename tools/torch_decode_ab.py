#!/usr/bin/env python3
"""Host time of the port's serving decode step, for an A/B of two checkouts.

    python3 tools/torch_decode_ab.py [ROOT]     # ROOT: a checkout (default: this one)

Measures the checkout at ROOT in this process: smollm-135m at full width
(30 layers, bf16), the serving pass of ``chip_smoke.py`` stepped by hand
(``tools/torch_serve_profile.py``'s ``timed_steps``) after a warm-up, twice;
then the host time of one call of the model's ``rmsnorm`` at decode rows
(8 x 576 bf16) and of one ``x + x`` beside it, the latter a yardstick of
the host's speed at that moment.  Prints one JSON line.

The host clock of a one-card machine drifts with its neighbours, so run
two checkouts in turns in fresh processes (parent, change, change,
parent, ...) and compare within one call.  Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds per call of ``fn`` (the device drained around)."""
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else Path(__file__).resolve().parent.parent).resolve()
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_ab.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.registry import get_model
    spec = importlib.util.spec_from_file_location(
        "serve_profile", root / "tools" / "torch_serve_profile.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = get_model("smollm-135m")
    params = model.init_params(seed=0)
    prefix, reqs = chip_smoke.serving_workload(model.cfg.vocab_size)
    prof.timed_steps(model, params, prefix, reqs[:2])            # warm-up
    runs = [prof.timed_steps(model, params, prefix, reqs) for _ in range(2)]
    x = torch.randn(8, 1, 576, device="cuda", dtype=torch.bfloat16)
    scale = torch.ones(576, device="cuda", dtype=torch.bfloat16)
    out = {"root": str(root),
           "decode_step_ms": [r["decode_step_ms_mean"] for r in runs],
           "prefill_ms_per_call": [r["prefill_ms_per_call"] for r in runs],
           "host_us_layers_rmsnorm": host_us(lambda: rmsnorm(x, scale, 1e-5)),
           "host_us_add": host_us(lambda: x + x)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
