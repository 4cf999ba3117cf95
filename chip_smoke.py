#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--out DIR]     # from the repository root

Phases, in order; any failure raises and the process exits non-zero:

1. device: the card's name and power limit, then the kernels' build
   (``src/repro_torch/csrc/*.cu`` -> one shared library, timed);
2. kernels against their plain PyTorch versions on the card, at the
   serving path's shapes (smollm-135m heads, and llama3-8b's), each timed
   beside its roofline bound and one PyTorch library call;
3. serving: smollm-135m at full width (30 layers, bf16, seeded random
   weights) through ``ContinuousBatchingEngine`` over a
   ``PagedKVCachePool``, with a baked shared prefix, a chunked-prefill pass
   and an int8-arena pass; the kernels' launch counts are checked against
   the engine's decode steps and prefill calls;
4. parity: a 2-layer fp32 smollm-135m at full width on the card (kernels)
   against the same seeded weights on the CPU (plain versions).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Detailed results go to
``DIR/chip_smoke.json`` (default ``results/``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
DEFAULT_OUT = ROOT / "results"

# NVIDIA H100 SXM peaks (data sheet, dense): HBM bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SMOLLM = dict(H=9, KV=3, d=64)
LLAMA3_8B = dict(H=32, KV=8, d=128)
PAGE_SIZE = 8
SERVE_LAYERS = 30


def _import_port():
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch/ not found beside "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, str(src))


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, graph_calls: int = 10) -> float:
    """Mean device time of one ``fn()`` in ms.

    ``fn`` is captured ``graph_calls`` times into a CUDA graph and the
    graph replayed ``reps`` times between CUDA events, so host launch
    overhead is not in the number.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(graph_calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * graph_calls)


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """The least time the card could take: max(ops / peak, bytes / HBM)."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def paged_decode_work(B, H, KV, d, ps, lengths, q_dtype, kv_dtype) -> tuple:
    """(FLOPs, bytes) the paged decode of these lengths needs: each valid
    K/V row (and its scale) read once, q read and out written once."""
    rows = int(np.sum(lengths))
    kv_elt = torch.empty((), dtype=kv_dtype).element_size()
    q_elt = torch.empty((), dtype=q_dtype).element_size()
    nbytes = 2 * rows * KV * d * kv_elt + 2 * B * H * d * q_elt
    if kv_dtype == torch.int8:
        nbytes += 2 * rows * KV * 4
    nbytes += 4 * int(np.sum(-(-np.asarray(lengths) // ps))) + 4 * B
    flops = 4 * rows * H * d                      # QK and PV, per query head
    return flops, nbytes


def flash_work(B, H, KV, S, T, d, dtype, causal=True) -> tuple:
    """(FLOPs, bytes) of causal attention with the bottom-right mask."""
    rows = np.arange(S)
    pairs = int(np.minimum(T, rows + (T - S) + 1).sum()) if causal else S * T
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = elt * (2 * B * H * S * d + 2 * B * KV * T * d)
    return 4 * B * H * pairs * d, nbytes


def sdpa_gqa(q, k, v, **kw):
    """One ``scaled_dot_product_attention`` call with grouped KV heads."""
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def make_paged_case(gen, B, H, KV, d, ps, max_len, lengths, q_dtype,
                    int8: bool, device):
    """A random arena with shuffled disjoint page tables; rows of length 1
    and an all-null table stand for free slots, as in serving."""
    from repro_torch.models import quant
    NB = -(-max_len // ps)
    n_pages = 1 + B * NB
    kp = torch.randn((n_pages, ps, KV, d), generator=gen)
    vp = torch.randn((n_pages, ps, KV, d), generator=gen)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    pt = perm[:B * NB].reshape(B, NB).to(torch.int32)
    for b, n in enumerate(lengths):
        if n == 1:
            pt[b] = 0                              # free slot: null page
    q = torch.randn((B, H, d), generator=gen)
    case = {"q": q.to(device, q_dtype), "page_table": pt.to(device),
            "lengths": torch.as_tensor(lengths, dtype=torch.int32).to(device)}
    if int8:
        kq, ks = quant.quantize_rows(kp)
        vq, vs = quant.quantize_rows(vp)
        case.update(k_pages=kq.to(device), v_pages=vq.to(device),
                    k_scales=ks.to(device), v_scales=vs.to(device))
    else:
        case.update(k_pages=kp.to(device, q_dtype), v_pages=vp.to(device, q_dtype),
                    k_scales=None, v_scales=None)
    return case


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    limit = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"device: {name} | nvidia-smi: {limit}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (matmul and cudnn)")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"kernels built: {lib} in {build_s:.1f} s")
    log = (lib.parent / "build.log").read_text()
    for line in log.splitlines():
        if "spill" in line and "0 bytes spill stores" not in line:
            print("ptxas:", line.strip())
    return {"name": name, "nvidia_smi": limit, "build_s": build_s,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_kernels(device) -> list:
    """Every kernel against its plain version on the card, timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    gen = torch.Generator().manual_seed(0)
    results = []
    rng = np.random.default_rng(0)

    paged = []
    for heads, tag in ((SMOLLM, "smollm"), (LLAMA3_8B, "llama3-8b")):
        for B in (1, 8):
            lengths = [512] if B == 1 else (
                [1] + rng.integers(2, 513, B - 2).tolist() + [512])
            for q_dtype, int8 in ((torch.bfloat16, False), (torch.float32, False),
                                  (torch.bfloat16, True), (torch.float32, True)):
                if tag == "llama3-8b" and q_dtype == torch.float32:
                    continue
                paged.append((tag, heads, B, lengths, q_dtype, int8))
    for tag, hd, B, lengths, q_dtype, int8 in paged:
        c = make_paged_case(gen, B, hd["H"], hd["KV"], hd["d"], PAGE_SIZE, 512,
                            lengths, q_dtype, int8, device)
        args = (c["q"], c["k_pages"], c["v_pages"], c["page_table"], c["lengths"])
        kw = {"k_scales": c["k_scales"], "v_scales": c["v_scales"]}
        out = paged_decode_attention(*args, **kw)
        want = ref.paged_decode_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        tol = 2e-5 if q_dtype == torch.float32 else 2e-2
        kern_ms = time_ms(lambda: paged_decode_attention(*args, **kw))
        plain_ms = time_ms(lambda: ref.paged_decode_attention_ref(*args, **kw))
        NB, T = c["page_table"].shape[1], c["page_table"].shape[1] * PAGE_SIZE
        mask = (torch.arange(T, device=device)[None, :]
                < c["lengths"][:, None].long())[:, None, None, :]

        def library():
            kp, vp = c["k_pages"], c["v_pages"]
            if int8:
                kp = kp.to(q_dtype) * c["k_scales"].to(q_dtype)[..., None]
                vp = vp.to(q_dtype) * c["v_scales"].to(q_dtype)[..., None]
            pt = c["page_table"].long()
            k = kp[pt].reshape(B, T, hd["KV"], hd["d"]).transpose(1, 2)
            v = vp[pt].reshape(B, T, hd["KV"], hd["d"]).transpose(1, 2)
            return sdpa_gqa(c["q"][:, :, None], k, v, attn_mask=mask)

        lib_ms = time_ms(library)
        kv_dtype = torch.int8 if int8 else q_dtype
        flops, nbytes = paged_decode_work(B, hd["H"], hd["KV"], hd["d"], PAGE_SIZE,
                                          lengths, q_dtype, kv_dtype)
        b_ms, b_by = bound_ms(flops, nbytes, q_dtype)
        res = {"kernel": "paged_decode_attention", "shape": tag, "B": B,
               "H": hd["H"], "KV": hd["KV"], "d": hd["d"], "ps": PAGE_SIZE,
               "max_len": int(max(lengths)), "q_dtype": str(q_dtype)[6:],
               "kv_dtype": str(kv_dtype)[6:], "max_abs_err": err, "tol": tol,
               "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        results.append(res)
        print(json.dumps(res))
        if not err <= tol:
            raise AssertionError(f"paged_decode_attention disagrees: {res}")

    flash_cases = []
    for heads, tag in ((SMOLLM, "smollm"), (LLAMA3_8B, "llama3-8b")):
        flash_cases += [(tag, heads, 1, 384, 384, torch.bfloat16, 0.0),
                        (tag, heads, 1, 64, 320, torch.bfloat16, 0.0),
                        (tag, heads, 1, 96, 96, torch.float32, 0.0)]
    flash_cases += [("smollm", SMOLLM, 1, 384, 384, torch.float32, 0.0),
                    ("smollm", SMOLLM, 2, 256, 256, torch.bfloat16, 30.0),
                    ("smollm", SMOLLM, 1, 200, 333, torch.float32, 30.0)]
    for tag, hd, B, S, T, dtype, softcap in flash_cases:
        q = torch.randn((B, hd["H"], S, hd["d"]), generator=gen).to(device, dtype)
        k = torch.randn((B, hd["KV"], T, hd["d"]), generator=gen).to(device, dtype)
        v = torch.randn((B, hd["KV"], T, hd["d"]), generator=gen).to(device, dtype)
        out = flash_attention(q, k, v, causal=True, softcap=softcap)
        want = ref.flash_attention_ref(q, k, v, causal=True, softcap=softcap)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        kern_ms = time_ms(lambda: flash_attention(q, k, v, softcap=softcap))
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, softcap=softcap))
        lib_ms = None
        if softcap == 0.0:           # SDPA has no softcap: no library call
            mask = (torch.arange(T, device=device)[None, :]
                    <= torch.arange(S, device=device)[:, None] + (T - S))
            lib_kw = {"is_causal": True} if S == T else {"attn_mask": mask}
            lib_ms = time_ms(lambda: sdpa_gqa(q, k, v, **lib_kw))
        flops, nbytes = flash_work(B, hd["H"], hd["KV"], S, T, hd["d"], dtype)
        b_ms, b_by = bound_ms(flops, nbytes, dtype)
        res = {"kernel": "flash_attention", "shape": tag, "B": B, "H": hd["H"],
               "KV": hd["KV"], "d": hd["d"], "S": S, "T": T,
               "dtype": str(dtype)[6:], "softcap": softcap, "max_abs_err": err,
               "tol": tol, "ms": kern_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        results.append(res)
        print(json.dumps(res))
        if not err <= tol:
            raise AssertionError(f"flash_attention disagrees: {res}")
    return results


def _serve_requests(vocab: int, prefix: np.ndarray, n: int = 12, seed: int = 0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        if i < 3:                    # three requests share the baked prefix
            tail = rng.integers(1, vocab, int(rng.integers(16, 257)))
            reqs.append(np.concatenate([prefix, tail]).astype(np.int32))
        else:
            reqs.append(rng.integers(1, vocab, int(rng.integers(64, 385))
                                     ).astype(np.int32))
    return reqs


def serving_engine(model, params, prefix: np.ndarray, chunk_tokens=None,
                   kv_dtype=None):
    """The serving setup every pass uses: 8 slots over a fresh paged arena
    (max_len 512, page size 8) with ``prefix`` baked and registered."""
    from repro_torch.runtime import (ContinuousBatchingEngine, PagedKVCachePool,
                                     PrefixIndex)
    pool = PagedKVCachePool(model, n_slots=8, max_len=512, page_size=PAGE_SIZE,
                            kv_dtype=kv_dtype)
    cache = model.make_cache(1, pool.padded_len)
    _, cache = model.prefill(params, {"tokens": prefix[None]}, cache)
    index = PrefixIndex(PAGE_SIZE)
    index.register(pool.bake_prefix(cache, prefix))
    return ContinuousBatchingEngine(model, params, pool=pool, prefix_index=index,
                                    chunk_tokens=chunk_tokens)


def serving_workload(vocab: int):
    """The shared prefix (131 tokens: 16 pages aliased plus a partial page
    copied on write) and the 12 prompts of every serving pass."""
    prefix = np.random.default_rng(1).integers(1, vocab, 131).astype(np.int32)
    return prefix, _serve_requests(vocab, prefix)


def phase_serve(device) -> list:
    """smollm-135m at full width through the paged continuous-batching
    engine: plain, chunked-prefill and int8-arena passes."""
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_model
    model = get_model("smollm-135m", device=device)
    assert model.cfg.n_layers == SERVE_LAYERS and model.cfg.d_model == 576
    t0 = time.perf_counter()
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    print(f"smollm-135m: {model.cfg.n_layers} layers, d_model "
          f"{model.cfg.d_model}, {model.dtype}, weights in "
          f"{time.perf_counter() - t0:.1f} s")
    vocab = model.cfg.vocab_size
    prefix, reqs = serving_workload(vocab)
    passes = [("paged", {}), ("chunked", {"chunk_tokens": 64}),
              ("int8", {"kv_dtype": "int8"})]
    out = []
    tokens_by_pass = {}
    for warm, (name, kw) in [(True, passes[0])] + [(False, p) for p in passes]:
        eng = serving_engine(model, params, prefix, **kw)
        pool = eng.pool
        batch = reqs[:2] if warm else reqs
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ids = [eng.submit(p, 16) for p in batch]
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if warm:
            eng.close()
            continue
        res = [results[i] for i in ids]
        bad = [r for r in res if r.status != "done" or r.n_generated != 16]
        if bad:
            raise AssertionError(f"{name}: unfinished requests {bad}")
        for r in res:
            if not ((r.tokens >= 0) & (r.tokens < vocab)).all():
                raise AssertionError(f"{name}: token out of range {r.tokens}")
        if counts["paged_decode_attention"] != eng.n_decode_steps * SERVE_LAYERS:
            raise AssertionError(f"{name}: paged decode launches {counts} != "
                                 f"{eng.n_decode_steps} steps x {SERVE_LAYERS}")
        if counts["flash_attention"] != eng.n_prefill_calls * SERVE_LAYERS:
            raise AssertionError(f"{name}: flash launches {counts} != "
                                 f"{eng.n_prefill_calls} prefills x {SERVE_LAYERS}")
        hits = sum(r.reused_prefix_len > 0 for r in res)
        if hits < 2 or pool.stats["shared_pages_mapped"] < 2 * (128 // PAGE_SIZE):
            raise AssertionError(f"{name}: prefix hits {hits}, {pool.stats}")
        ttft = np.asarray([r.ttft_s for r in res]) * 1e3
        e2e = np.asarray([r.e2e_s for r in res]) * 1e3
        n_tok = sum(r.n_generated for r in res)
        tokens_by_pass[name] = [r.tokens for r in res]
        row = {"pass": name, "requests": len(res),
               "prompt_lens": [int(r.prompt_len) for r in res],
               "prefix_hits": int(hits), "pool_stats": dict(pool.stats),
               "decode_steps": eng.n_decode_steps,
               "prefill_calls": eng.n_prefill_calls, "launches": counts,
               "wall_s": wall, "tokens_per_s": n_tok / wall,
               "ttft_ms_p50": float(np.percentile(ttft, 50)),
               "ttft_ms_max": float(ttft.max()),
               "e2e_ms_p50": float(np.percentile(e2e, 50)),
               "e2e_ms_max": float(e2e.max()),
               "peak_used_pages": pool.peak_used_pages}
        out.append(row)
        print(json.dumps(row))
        eng.close()
    base = tokens_by_pass["paged"]
    for name in ("chunked", "int8"):
        same = sum(int((a == b).sum()) for a, b in zip(base, tokens_by_pass[name]))
        print(f"tokens equal to the plain pass: {name} {same}/{16 * len(base)}")
    return out


def phase_parity(device) -> dict:
    """2-layer fp32 smollm-135m at full width: card (kernels) vs CPU
    (plain versions), same seeded weights."""
    from repro_torch.models.registry import get_model
    from repro_torch.models.registry import get_config
    from repro_torch.runtime import PagedKVCachePool
    cfg = get_config("smollm-135m").replace(n_layers=2, dtype="float32")
    prompt = np.random.default_rng(2).integers(1, cfg.vocab_size, 100).astype(np.int32)
    runs = {}
    for dev in (device, "cpu"):
        model = get_model(cfg, device=dev)
        params = model.init_params(seed=1)
        pool = PagedKVCachePool(model, n_slots=2, max_len=128, page_size=PAGE_SIZE)
        cache = model.make_cache(1, pool.padded_len)
        logits, cache = model.prefill(params, {"tokens": prompt[None]}, cache)
        slot = pool.alloc(len(prompt), 8)
        pool.write_prompt(slot, cache, len(prompt))
        all_logits = [logits[0].float().cpu()]
        toks = [int(logits[0].argmax())]
        pos = np.zeros(2, np.int32)
        pos[slot] = len(prompt)
        for _ in range(8):
            pool.ensure_len(slot, int(pos[slot]) + 1)
            tok = np.zeros((2, 1), np.int32)
            tok[slot, 0] = toks[-1]
            lg, _ = model.decode_step_paged(params, pool.cache, {"tokens": tok},
                                            pos, pool.device_page_table(),
                                            PAGE_SIZE)
            all_logits.append(lg[slot].float().cpu())
            toks.append(int(lg[slot].argmax()))
            pos[slot] += 1
        runs[str(dev)] = (torch.stack(all_logits), toks)
    (lg_gpu, tk_gpu), (lg_cpu, tk_cpu) = runs[str(device)], runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    res = {"max_abs_logit_err": err, "tol": 1e-3, "tokens_card": tk_gpu,
           "tokens_cpu": tk_cpu}
    print(json.dumps({"parity": res}))
    if not err <= 1e-3 or tk_gpu != tk_cpu:
        raise AssertionError(f"card vs CPU parity failed: {res}")
    return res


def kernel_summary(kernels: list, serve: list) -> list:
    """One entry per kernel (and the int8 variant) at the main path's
    shapes, with its launches from the serving passes."""
    def pick(**kw):
        return next(r for r in kernels if all(r.get(k) == v for k, v in kw.items()))

    launches = {"paged": 0, "int8": 0, "flash": 0}
    for row in serve:
        key = "int8" if row["pass"] == "int8" else "paged"
        launches[key] += row["launches"]["paged_decode_attention"]
        launches["flash"] += row["launches"]["flash_attention"]
    entries = [
        ("paged_decode_attention",
         pick(kernel="paged_decode_attention", shape="smollm", B=8,
              q_dtype="bfloat16", kv_dtype="bfloat16"),
         "src/repro_torch/csrc/paged_decode_attention.cu",
         "src/repro/kernels/paged_decode_attention.py:129", launches["paged"]),
        ("paged_decode_attention[int8]",
         pick(kernel="paged_decode_attention", shape="smollm", B=8,
              q_dtype="bfloat16", kv_dtype="int8"),
         "src/repro_torch/csrc/paged_decode_attention.cu",
         "src/repro/kernels/paged_decode_attention.py:129", launches["int8"]),
        ("flash_attention",
         pick(kernel="flash_attention", shape="smollm", S=384, T=384,
              dtype="bfloat16"),
         "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:86", launches["flash"]),
    ]
    return [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
            for name, r, src, rep, n in entries]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT,
                    help="directory for chip_smoke.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    _import_port()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    dev = phase_device()
    kernels = phase_kernels(device)
    serve = phase_serve(device)
    parity = phase_parity(device)
    summary = kernel_summary(kernels, serve)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "chip_smoke.json").write_text(json.dumps(
        {"device": dev, "kernels": kernels, "serve": serve, "parity": parity,
         "summary": summary, "seconds": time.perf_counter() - t0}, indent=1))
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
