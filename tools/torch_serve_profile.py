#!/usr/bin/env python3
"""Where the serving time goes: the port's serving pass on one card.

    python3 tools/torch_serve_profile.py [--arch ARCH] [--out DIR]   # from the repository root

Runs the serving pass of ``chip_smoke.py`` twice after a warm-up:
``--arch smollm-135m`` (the default; 30 layers, bf16, 8 slots over the
paged arena, 12 requests of 16 tokens, a baked shared prefix) or
``--arch zamba2-2.7b`` (54 Mamba2 layers and the shared attention block,
bf16, 8 slots over the dense pool, phase 8's 12 prompts of 64-384 tokens,
16 new tokens each):

1. stepping the engine by hand, with every ``step()`` timed on the host
   clock after a device synchronise, and each step classed by what it did
   (admitted and prefilled requests, or decoded only);
2. under ``torch.profiler`` for the device time by kernel name, the
   device-busy share of the wall time, the host ops that cost most, and
   the kernel launches (``cudaLaunchKernel`` calls) per layer of each
   model call (a decode step or a prefill call).

Prints one JSON object and writes it to ``DIR/serve_profile.json``
(default ``results/``).
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def new_engine(model, params, prefix):
    """The serving engine of ``chip_smoke.py`` for the model's family: the
    paged arena with ``prefix`` baked, or zamba's dense slot pool."""
    if prefix is None:
        from repro_torch.runtime import ContinuousBatchingEngine
        return ContinuousBatchingEngine(model, params, n_slots=8, max_len=512)
    return chip_smoke.serving_engine(model, params, prefix)


def workload(model):
    """(prefix or None, the 12 prompts) of the model's serving pass."""
    vocab = model.cfg.vocab_size
    if model.cfg.family == "zamba":
        rng = np.random.default_rng(10)
        return None, [rng.integers(1, vocab, n).astype(np.int32)
                      for n in chip_smoke.ZAMBA_LENGTHS]
    return chip_smoke.serving_workload(vocab)


def timed_steps(model, params, prefix, reqs) -> dict:
    """Wall time of every engine step, split into prefill and decode steps."""
    eng = new_engine(model, params, prefix)
    for p in reqs:
        eng.submit(p, 16)
    prefill_ms, decode_ms = [], []
    alive = True
    while alive:
        n_prefill = eng.n_prefill_calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alive = eng.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        (prefill_ms if eng.n_prefill_calls > n_prefill else decode_ms).append(dt)
    prefills = eng.n_prefill_calls
    eng.close()
    return {"prefill_steps": len(prefill_ms), "prefill_calls": prefills,
            "prefill_step_ms_total": sum(prefill_ms),
            "prefill_ms_per_call": sum(prefill_ms) / max(prefills, 1),
            "decode_steps": len(decode_ms),
            "decode_step_ms_mean": float(np.mean(decode_ms)) if decode_ms else None,
            "decode_step_ms_total": sum(decode_ms)}


def profiled_pass(model, params, prefix, reqs) -> dict:
    """Device time by kernel and busy share over one whole pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = new_engine(model, params, prefix)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in reqs:
            eng.submit(p, 16)
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    calls = eng.n_decode_steps + eng.n_prefill_calls
    eng.close()
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # device-side events only: a CPU op reports the device time of the
    # kernels it launched as its own, so summing both counts it twice
    kernels = sorted(((e.key, device_us(e) / 1e3, e.count) for e in events
                      if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                     key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events),
                  key=lambda r: -r[1])
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    # device ms of the hand-written kernels, by wrapper (ssd_scan launches
    # three kernels; rmsnorm two kinds)
    groups = {"ssd_scan": ("chunk_state_kernel", "state_pass_kernel",
                           "chunk_out_kernel"),
              "rmsnorm": ("rmsnorm_vec_kernel", "rmsnorm_scalar_kernel")}
    by_wrapper = {g: sum(ms for k, ms, _ in kernels if any(n in k for n in names))
                  for g, names in groups.items()}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "kernel_ms_by_wrapper": by_wrapper,
            "device_busy_share": device_ms / wall_ms,
            "model_calls": calls, "kernel_launches": launches,
            "launches_per_layer_call": launches / (calls * model.cfg.n_layers),
            "kernels_top": [{"name": k[:90], "ms": ms, "count": n}
                            for k, ms, n in kernels[:15]],
            "host_ops_top": [{"name": k[:90], "self_ms": ms, "count": n}
                             for k, ms, n in host[:15]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=chip_smoke.DEFAULT_OUT,
                    help="directory for serve_profile.json")
    ap.add_argument("--arch", default="smollm-135m",
                    choices=["smollm-135m", "zamba2-2.7b"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_profile.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    chip_smoke._import_port()
    from repro_torch.models.registry import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    model = get_model(args.arch)
    params = model.init_params(seed=0)
    prefix, reqs = workload(model)
    timed_steps(model, params, prefix, reqs[:2])           # warm-up
    steps = timed_steps(model, params, prefix, reqs)
    prof = profiled_pass(model, params, prefix, reqs)
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"device": smi, "torch": torch.__version__, "arch": args.arch,
           "steps": steps,
           "profile": prof}
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "serve_profile.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
