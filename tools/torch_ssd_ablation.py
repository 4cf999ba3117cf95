#!/usr/bin/env python3
"""Where the ``ssd_scan`` kernel's time goes: its parts switched off in turn.

    python3 tools/torch_ssd_ablation.py [--out DIR]   # from the repository root

Builds ``src/repro_torch/csrc/ssd_scan.cu`` as it is and in variants with
one part removed by a source substitution, each into its own library
under ``DIR/ssd_ablation/``, and times every variant on the card at
zamba2-2.7b's shapes (H = 80, dh = ds = 64, chunk 128) with
``chip_smoke.time_ms`` (CUDA graphs and events).  The parts: the three
launches (chunk states, the state pass, chunk outputs), and inside them
the chunk states' prefix sums and tensor-core products, the chunk
outputs' C h_prev term, score tiles (C B^T), decay (the exponentials of
the mask) and score-times-X products.  A part's cost is the full
kernel's time less the variant's.  The variants compute wrong results:
they are timing probes only.  Prints one JSON object with the card's
name and power limit and writes it to ``DIR/ssd_ablation.json`` (default
``results/``).  Needs a CUDA device and nvcc.
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
    "chunk_states": [("  k1<<<", "  if (false) k1<<<")],
    "state_pass": [("err = launch_after(state_pass_kernel,",
                    "if (false) err = launch_after(state_pass_kernel,")],
    "chunk_outputs": [("return launch_after(dh % 64 == 0 ? k3a : k3b,",
                       "return cudaSuccess; launch_after(dh % 64 == 0 ? k3a : k3b,")],
    "state_prefix": [("for (int i = 0; i < kQMax; i += 4) {",
                      "for (int i = 0; i < 0; i += 4) {")],
    "state_products": [("mma3<false, kExactB>(acc[nt],",
                        "if (false) mma3<false, kExactB>(acc[nt],")],
    "c_h_prev": [("const bool has_prev = k > 0 || has_h0;",
                  "const bool has_prev = false;")],
    "scores": [("mma3<kExact, kExact>(sc[u],", "if (false) mma3<kExact, kExact>(sc[u],")],
    "decay": [("* exp2f(a_i0 - a_j0)", "* (a_i0 - a_j0)"),
              ("* exp2f(a_i0 - a_j1)", "* (a_i0 - a_j1)"),
              ("* exp2f(a_i1 - a_j0)", "* (a_i1 - a_j0)"),
              ("* exp2f(a_i1 - a_j1)", "* (a_i1 - a_j1)")],
    "score_x": [("mma3<false, false>(acc[nt],", "if (false) mma3<false, false>(acc[nt],")],
}
# (B, S, B / C dtype, with h0)
SHAPES = ((1, 128, torch.bfloat16, False), (1, 384, torch.bfloat16, False),
          (1, 512, torch.bfloat16, False), (4, 256, torch.bfloat16, True),
          (4, 256, torch.float32, True))


def build_variants(out: Path) -> dict:
    """{variant: library path}, all compiled in parallel."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    variants = {"full": []}
    variants.update({f"no_{k}": v for k, v in PARTS.items()})
    variants["launches_only"] = [       # staging and the state pass remain
        p for k in ("state_prefix", "state_products", "c_h_prev", "scores", "decay",
                    "score_x") for p in PARTS[k]]
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
    for B, S, dtype, with_h0 in SHAPES:
        xb, Bm, Cm, ld, h0 = chip_smoke.make_ssd_case(gen, B, S, dtype, with_h0,
                                                      device)
        y = torch.empty_like(xb)
        h = torch.empty((B, c["H"], c["dh"], c["ds"]), device=device)
        scratch = torch.empty(wrapper.scratch_floats(B, S, c["H"], c["dh"], c["ds"],
                                                     c["Q"]), device=device)
        strides = [t.stride(i) for t in (Bm, Cm) for i in (0, 1)]

        def call():
            err = fn(xb.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), ld.data_ptr(),
                     None if h0 is None else h0.data_ptr(), scratch.data_ptr(),
                     y.data_ptr(), h.data_ptr(), B, S, c["H"], c["dh"], c["ds"],
                     c["Q"], *strides, wrapper._DTYPES[dtype],
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed, cudaError_t {err}")

        call()
        tag = f"B{B}_S{S}_{str(dtype)[6:]}" + ("_h0" if with_h0 else "")
        out[tag] = chip_smoke.time_ms(call) * 1e3
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
