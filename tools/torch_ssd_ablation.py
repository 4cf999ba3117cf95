#!/usr/bin/env python3
"""Where the ``ssd_scan`` kernel's time goes: its parts switched off in turn.

    python3 tools/torch_ssd_ablation.py [--out DIR]   # from the repository root

Builds ``src/repro_torch/csrc/ssd_scan.cu`` as it is and in variants with
one part removed by a source substitution (the C B^T launch, the staging
loads, the score tiles, the y accumulation, the state update), each into
its own library under ``DIR/ssd_ablation/``, and times every variant on
the card at zamba2-2.7b's shapes (H = 80, dh = ds = 64, chunk 128) with
``chip_smoke.time_ms`` (CUDA graphs and events).  A part's cost is the
full kernel's time less the variant's.  The variants compute wrong
results: they are timing probes only.  Prints one JSON object with the
card's name and power limit and writes it to ``DIR/ssd_ablation.json``
(default ``results/``).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# part -> (text in the source, its replacement)
PARTS = {
    "cb_launch": [("  cb_k<<<", "  if (false) cb_k<<<")],
    "staging_loads": [
        ("const float c = to_f32(Cb[row * cs.s + s]);", "const float c = 0.f;"),
        ("const float bb = to_f32(Bb[row * bs.s + s]);", "const float bb = 0.f;"),
        ("*reinterpret_cast<const float4*>(\n"
         "            xbase + (c0 + min(i, n - 1)) * xrow + 4 * q);",
         "make_float4(0.f, 0.f, 0.f, 0.f);")],
    "score_tiles": [("if (j0 <= i0 + 3) {", "if (false) {")],
    "y_rows": [("        if (i < n) {\n          const float* wr",
                "        if (false) {\n          const float* wr")],
    "state_update": [("      for (int j = 0; j < n; ++j) {\n        const float xv",
                      "      for (int j = 0; j < 0; ++j) {\n        const float xv")],
}
SHAPES = ((1, 128, torch.bfloat16), (1, 384, torch.bfloat16),
          (1, 512, torch.bfloat16), (4, 256, torch.float32))


def build_variants(out: Path) -> dict:
    """{variant: library path}, all compiled in parallel."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    variants = {"full": []}
    variants.update({f"no_{k}": v for k, v in PARTS.items()})
    variants["staging_and_scan_only"] = [
        p for k in ("cb_launch", "score_tiles", "y_rows", "state_update")
        for p in PARTS[k]]
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
             "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    return {name: out / f"{name}.so" for name in variants}


def time_variant(lib: Path, device) -> dict:
    from repro_torch.kernels import ssd_scan as wrapper
    fn = ctypes.CDLL(str(lib)).repro_ssd_scan
    fn.argtypes = wrapper._ARGTYPES
    fn.restype = ctypes.c_int
    gen = torch.Generator().manual_seed(0)
    c = chip_smoke.ZAMBA2_SSD
    out = {}
    for B, S, dtype in SHAPES:
        xb, Bm, Cm, ld, _ = chip_smoke.make_ssd_case(gen, B, S, dtype, False,
                                                     device)
        y = torch.empty_like(xb)
        h = torch.empty((B, c["H"], c["dh"], c["ds"]), device=device)
        cb = torch.empty((B, -(-S // c["Q"]), 128, 128), device=device)
        strides = [t.stride(i) for t in (Bm, Cm) for i in (0, 1)]

        def call():
            err = fn(xb.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), ld.data_ptr(),
                     None, cb.data_ptr(), y.data_ptr(), h.data_ptr(), B, S,
                     c["H"], c["dh"], c["ds"], c["Q"], *strides,
                     wrapper._DTYPES[dtype],
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed, cudaError_t {err}")

        call()
        out[f"B{B}_S{S}_{str(dtype)[6:]}"] = chip_smoke.time_ms(call) * 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=chip_smoke.DEFAULT_OUT,
                    help="directory for ssd_ablation.json and the variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ssd_ablation.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    chip_smoke._import_port()
    device = torch.device("cuda", 0)
    libs = build_variants(args.out / "ssd_ablation")
    times = {name: time_variant(lib, device) for name, lib in libs.items()}
    full = times["full"]
    cost = {part: {shape: full[shape] - times[f"no_{part}"][shape]
                   for shape in full} for part in PARTS}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"device": smi, "us": times, "part_cost_us": cost}
    (args.out / "ssd_ablation.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
