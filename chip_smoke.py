#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--out DIR]     # from the repository root

Phases, in order; any failure raises and the process exits non-zero:

1. device: the card's name and power limit, the host's total and
   available memory (``/proc/meminfo``, printed again after every phase
   with its wall seconds), the kernels' build
   (``src/repro_torch/csrc/*.cu`` -> one shared library, timed), the
   attention kernels' registers, shared memory and spills (``-Xptxas
   -v``) and the measured pinned host-to-device copy rate, from a block of
   PyTorch's pinned allocator and from a view into a host-pool buffer
   registered in place (``HostBuffer``: ``is_pinned()`` and the rate);
2. kernels against their plain PyTorch versions on the card, at the
   serving path's shapes (smollm-135m heads and rows, llama3-8b's,
   llama2-13b's, phi3.5-moe's and deepseek-v3's rows (7168; ``q_a_norm``
   rows of 1536; ``kv_a_norm`` rows of 512 read in place at a row stride
   of 576, on the kernel's 16-byte load path), qwen3-14b's and
   chameleon-34b's head-norm rows; paged and dense decode also at B = 1,
   T = 4096 and at lengths shorter than one split, length 0 giving
   zeros), each timed beside its roofline bound and one PyTorch library
   call; rmsnorm also in its residual form (``s`` equal to ``x + r`` and
   ``y`` to the unfused kernel on ``s``, bit for bit, timed beside ``x + r;
   F.rms_norm`` and ``x + r`` then the kernel); then, at smollm-135m's,
   llama3-8b's and gemma-2b's heads, bitwise
   invariance of the bf16 flash, decode and paged decode kernels (a
   suffix prefill's rows equal the whole prefill's, a sequence alone
   equals it in a batch, a repeated call equals the first) and paged
   decode equal to dense decode over the same rows (bf16 and fp32,
   lengths 0 to 512); then at llama2-13b's heads (40 / 40 / 128, G = 1)
   and chameleon-34b's (64 / 8 / 128): paged decode (bf16 and int8) and
   dense decode at B = 8 and at B = 1, T = 4096, flash at S = T = 384,
   and the invariance checks;
3. serving: smollm-135m at full width (30 layers, bf16, seeded random
   weights) through ``ContinuousBatchingEngine`` over a
   ``PagedKVCachePool``, with a baked shared prefix, a chunked-prefill pass
   and an int8-arena pass; the kernels' launch counts (attention and
   rmsnorm, 2L+1 per model call, L of them with the residual add fused)
   are checked against the engine's decode steps and prefill calls;
4. parity: a 2-layer fp32 smollm-135m at full width on the card (kernels)
   against the same seeded weights on the CPU (plain versions), through
   the paged pool and through the sequential ``Engine``; the card's
   layer-streamed prefill of a forked session equals its monolithic one;
5. engine: the sequential ``Engine`` (dense cache, ``decode_attention``)
   on smollm-135m at full width, then a ``paged=False`` continuous pass
   over phase 3's workload, whose greedy tokens must all equal the paged
   pass's; launch counts checked per layer and step;
6. TIDAL: ``FaaSRuntime`` on smollm-135m at full width with a static
   function (131-token template prompt) and a LoRA function, ~16
   invocations through the gateway's pump thread covering cold, warm and
   fork; streamed prefill, byte accounting, stream order, the forking
   guard and fork-equals-warm tokens are checked, and the first
   invocation's TTFT is measured in fresh processes with and without
   prewarming;
7. tenants: a shared smollm-135m base at full width with a 4-row adapter
   bank (wq, wv; rank 8) serving three LoRA functions and the base, 16
   invocations through the pump thread, at least one decode step mixing
   adapter rows; a 2-layer fp32 check of each adapter function against
   its merged-weight model; then the control plane: a learned 128-token
   prefix baked after three misses and reused by the fourth invocation,
   and a 24-request open-loop Poisson replay at 4 qps;
8. ssm: ``ssd_scan`` against both of its plain versions (chunked and
   sequential) at zamba2-2.7b's shapes (H = 80, dh = ds = 64, chunk 128;
   S = 64, 128, 384, 512, a ragged 200, and B = 4 with an initial state,
   whose sequences run alone must give the batch's bits; B and C in bf16
   and fp32), and ``flash_attention`` / ``decode_attention`` at
   zamba2's head dim of 80, all timed, with the bitwise invariance checks
   (paged equal to dense included) at zamba2's heads; then zamba2-2.7b at full width
   (54 Mamba2 layers and one shared attention block applied 9 times,
   bf16, seeded random weights) through a dense-pool
   ``ContinuousBatchingEngine`` (12 requests) and the sequential
   ``Engine`` (8 x 256 tokens, the continuous engine's tokens equal),
   with exact launch counts (ssd_scan 54 and flash 9 per prefill call,
   decode 9 per step, rmsnorm 127 per model call, 9 of them fused); a
   2-layer fp32 card
   against CPU check, streamed prefill equal to prefill, and
   ``FaaSRuntime`` cold / fork / warm for a static zamba function;
9. llama2-13b at full width and depth (40 layers, d_model 5120, 40 query
   and key heads of 128, bf16, 26 GB of seeded random weights drawn leaf
   by leaf): phase 3's paged serving passes (bf16 and int8 arenas), the
   sequential ``Engine`` (8 x 256 + 32) with the continuous engine's
   tokens equal to it, exact launch counts, the decode step at 8 busy
   slots (host ms, device-busy share under ``torch.profiler``) beside its
   byte bound, ``FaaSRuntime`` cold / warm / fork of a static function
   with the template prompt (every fork streams the whole model; fork
   tokens equal warm; peak device allocation under three copies), then a
   2-layer fp32 card against CPU check and streamed prefill equal to
   prefill;
10. phi3.5-moe-42b-a6.6b at full width (d_model 4096, 32 / 8 heads of
   128, 16 experts of 6400, top-2, capacity factor 1.25, bf16) and
   the largest depth of its 32 layers, at most 8, at which a warm copy, a
   fork's copy and the arena fit the card and the host's memory (printed
   as reduced, with the budget that stopped it): the paged serving passes at 8
   slots (plain, chunked, int8), the (token, k) pairs the capacity drops
   (decode and prefill), the plain and chunked passes again at cf = E/K
   (dropless), a 384-token prompt prefilled whole and in 64-token chunks
   (fp32 at one layer: the same expert choices and logits within 1e-3; in
   bf16 the expert choices that rounding flips are counted), a 4-slot pass
   (decode dropless) equal to the
   sequential ``Engine`` run prompt by prompt, the decode step beside its
   byte bound (the batched expert products read every expert),
   ``FaaSRuntime`` with a static and a LoRA function (``blocks.attn.wq``)
   cold / warm / fork, then 1-layer fp32 card against CPU checks with
   every call's routing and kept pairs equal, at 2 slots and at 8 slots
   with a prefill in 48-token chunks (pairs dropped at decode and in the
   chunks), and streamed prefill equal to prefill;
11. deepseek-v3-671b at full width (MLA: 128 heads, ranks 1536 / 512,
   dims 128 / 64 / 128; 256 experts of 2048, top-8, one shared expert;
   vocabulary 129,280; bf16) at the depth ``fitting_depth`` works out
   (one layer and the head are 26.7 GB; printed as reduced): phase 3's
   paged serving passes over the latent arena (plain, chunked, int8),
   the pairs the capacity drops at cf 1.25, a dropless 8-slot pass equal
   to the sequential ``Engine`` run prompt by prompt, the arena's bytes
   per token per layer (1,152 bf16, 584 int8) beside a GQA cache's at 128
   heads of 128, the decode step beside its byte bound, ``FaaSRuntime``
   cold / warm / fork of a static function (a fork streams the whole
   model; page-locked bytes within 1.05 times the weights, as in phases
   9 and 10); exact launch counts (rmsnorm 4L+1 per call, L fused, no
   attention kernel); then 1-layer fp32 card against CPU checks with the
   experts cut to 32 (logits within 1e-4 of the largest, routing and kept
   pairs equal) at 2 slots and at 8 slots with a 48-token chunked
   prefill, and streamed prefill equal to prefill;
12. xlstm-1.3b at full width and depth (48 layers: 42 mLSTM and 6 sLSTM
   blocks, d_model 2048, 4 heads, mLSTM head dim 1024, chunk 128,
   vocabulary 50,304, bf16, 7.21 GB of seeded random weights): rmsnorm at
   xLSTM's rows (8 and 512 rows of 2048 and 4096, both forms), then the
   dense-pool ``ContinuousBatchingEngine`` (8 slots, 12 requests of 16
   new tokens, prompts of 32 to 512 tokens that keep the reference's
   chunk rule; tokens/s, TTFT, decode host ms, state bytes per slot), the
   sequential ``Engine`` (8 x 256 + 32) with the continuous engine's
   tokens equal to it, exact launch counts (rmsnorm 103 per model call, 6
   with the residual fused; no attention kernel, no ``ssd_scan``), the
   decode step at 8 busy slots beside its byte bound (the weights, and
   the recurrent state read and written once), a 512-token prefill with
   its sLSTM time loop's share, ``FaaSRuntime`` cold / warm / fork of a
   static function (a fork streams the whole model; fork tokens equal
   warm; page-locked bytes within 1.05 times the weights), the peak
   allocation; then a 2-layer fp32 card against CPU check (one mLSTM
   and one sLSTM block: logits within 1e-4 of the largest, tokens equal)
   and streamed prefill equal to prefill;
13. whisper-medium at full width and depth (24 encoder and 24 decoder
   layers, d_model 1024, 16 heads of 64 (G = 1), d_ff 4096, vocabulary
   51,865 with a tied head, 448 decoder positions; bf16, 1.52 GB of
   seeded random weights): ``flash_attention`` at its shapes, non-causal
   at B = 8 over 1,500 keys with S = 1,500 (the encoder) and S = 4
   (cross-attention of a 4-token prompt) and causal at S = T = 64, and
   ``decode_attention`` at B = 8 over 1,500 rows (cross) and 448 rows at
   per-sequence lengths (self), bf16 and fp32, each against its plain
   version and timed beside SDPA and the bound; then
   ``Engine.generate(frames=)`` at 8 sequences over 1,500 frames
   (``make_frames``) with 4-token prompts and 444 new tokens, so 447 of
   the 448 decoder rows fill (TTFT: encoder, every layer's cross K/V and
   the prompt; decode host ms per step; tokens/s; peak allocation), with
   exact launch counts (72 flash per prefill, 48 ``decode_attention``
   per step, no rmsnorm, paged decode or ``ssd_scan``); each sequence
   alone against the batch over 32 tokens (printed, not asserted); the
   decode step over the filled cache beside its byte bound (decoder
   weights without the cross K/V projections, the tied head, the cross
   K/V and the self K/V rows); ``ContinuousBatchingEngine`` refusing the
   model; then a 2 + 2-layer fp32 card against CPU check over 1,500
   frames (logits within 1e-4 of the largest, 16 greedy tokens equal);
14. training, fp32: the backward kernels (``flash_attention_bwd`` at
   smollm's heads, S = T = 128 and 2,048 at B = 8, with a softcap, at
   phi3.5-moe's heads (32 / 8 / 128) over 512, whisper's non-causal
   encoder (1,500 over 1,500) and cross-attention (64 over 1,500);
   ``rmsnorm_bwd`` plain and residual at smollm's training rows and on
   strided q_norm rows) against their plain versions (1e-4 of the
   largest |grad|; 1e-5 for rmsnorm), each run twice to the same bits,
   timed beside the plain version, the library call's backward and the
   bound; then ``repro_torch.launch.train``'s ``train()`` on smollm-135m
   at full width and depth at the CLI's defaults (batch 8, seq 128,
   remat) for 20 steps with a checkpoint every 10, exact launches per
   step (flash 2L, rmsnorm 4L + 1, 2L fused, flash backward L, rmsnorm
   backward 2L + 1), step time, tokens/s and peak memory, a second run
   stopped at step 10 and resumed to 20 whose losses, parameters and
   optimizer state equal the first's bit for bit, the device-busy share
   of two steps under ``torch.profiler``, the loss falling over 5 steps
   on one batch, one step at seq 2,048; a 2-layer card-against-CPU step
   (loss 1e-5, grad norm 1e-4 relative, parameters 1e-5 of the largest);
   phi3.5-moe at full width and 1 of 32 layers (printed as reduced) and
   whisper-medium at full width and depth (2 x 1,500 frames, 64 decoder
   tokens), 3 steps each with exact launches (phi3.5-moe's load-balancing
   loss finite and nonzero).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Detailed results go to
``DIR/chip_smoke.json`` (default ``results/``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
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
# ("tf32": fp32 operands on the tensor cores, one TF32 pass)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}

SMOLLM = dict(H=9, KV=3, d=64)
LLAMA3_8B = dict(H=32, KV=8, d=128)
LLAMA2_13B = dict(H=40, KV=40, d=128)             # G = 1 at d = 128
CHAMELEON_34B = dict(H=64, KV=8, d=128)
GEMMA_2B = dict(H=8, KV=1, d=256)
ZAMBA2_ATTN = dict(H=32, KV=32, d=80)             # the shared attention block
ZAMBA2_SSD = dict(H=80, dh=64, ds=64, Q=128, d_inner=5120)
PAGE_SIZE = 8
SERVE_LAYERS = 30
RMSNORM_CASES = (("smollm-decode", (8, 1, 576)), ("smollm-prefill", (384, 576)),
                 ("qwen3-14b-head", (8, 1, 40, 128)),
                 ("llama3-8b-prefill", (384, 4096)),
                 ("chameleon-34b-head", (8, 1, 64, 128)),
                 ("llama2-13b-decode", (8, 1, 5120)),
                 ("llama2-13b-prefill", (384, 5120)),
                 ("phi3.5-moe-decode", (8, 1, 4096)),
                 ("deepseek-v3-decode", (8, 1, 7168)),
                 ("deepseek-v3-prefill", (384, 7168)),
                 ("deepseek-v3-q_a_norm", (8, 1, 1536)))
# MLA's kv_a_norm reads the latent rows of the wkv_a product in place:
# rows of 512 at a row stride of 576 (the latent and the rope key)
STRIDED_RMSNORM_CASES = (("deepseek-v3-kv_a_norm", (8, 1, 512), 576),)
# serving launches no backward kernel (training, phase 14, does)
NO_BACKWARD = {"flash_attention_bwd": 0, "rmsnorm_bwd": 0}
# zamba2-2.7b serving prompts: six take the JAX mixer's chunked branch
# (<= 128 tokens or a multiple of 128), six are ragged
ZAMBA_LENGTHS = (64, 200, 128, 300, 256, 150, 100, 333, 384, 250, 96, 180)


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


def decode_work(B, H, KV, d, lengths, dtype) -> tuple:
    """(FLOPs, bytes) of dense-cache decode over these lengths: each
    selected K/V row read once, q and the lengths read, out written."""
    rows = int(np.sum(lengths))
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * rows * KV * d * elt + 2 * B * H * d * elt + 4 * B
    return 4 * rows * H * d, nbytes


def flash_work(B, H, KV, S, T, d, dtype, causal=True) -> tuple:
    """(FLOPs, bytes) of attention, causal with the bottom-right mask or
    over every (row, key) pair."""
    rows = np.arange(S)
    pairs = int(np.minimum(T, rows + (T - S) + 1).sum()) if causal else S * T
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = elt * (2 * B * H * S * d + 2 * B * KV * T * d)
    return 4 * B * H * pairs * d, nbytes


def ssd_work(B, S, H, dh, ds, Q, bc_dtype, with_h0: bool) -> tuple:
    """(FLOPs, bytes) of the chunked SSD scan.  Per chunk of n rows the
    causal pairs j <= i number P = n (n + 1) / 2: C_i . B_j once per
    (batch, chunk) (it is the same for every head), then per head the
    scores times x (2 P dh), C times the state and the state update
    (2 n dh ds each).  Bytes: xb, B, C, the log decays and h0 read once,
    y and the final state written once.  The kernel runs these products
    on the tensor cores, so its bound takes them at the TF32 peak, one
    pass (the least any design could use)."""
    flops = 0
    for c0 in range(0, S, Q):
        n = min(Q, S - c0)
        pairs = n * (n + 1) // 2
        flops += B * 2 * pairs * ds + B * H * (2 * pairs * dh + 4 * n * dh * ds)
    bc = torch.empty((), dtype=bc_dtype).element_size()
    state = B * H * dh * ds * 4
    nbytes = (2 * B * S * H * dh * 4 + 2 * B * S * ds * bc + B * S * H * 4
              + state * (2 if with_h0 else 1))
    return flops, nbytes


def rmsnorm_work(shape, dtype, residual: bool = False) -> tuple:
    """(FLOPs, bytes) of RMSNorm: x read and y written once, the scale
    read once; square, add, and two multiplies per element.  With the
    residual fused in, r read and s = x + r written once more, and one
    more add per element."""
    n = int(np.prod(shape))
    elt = torch.empty((), dtype=dtype).element_size()
    if residual:
        return 5 * n, elt * (4 * n + shape[-1])
    return 4 * n, elt * (2 * n + shape[-1])


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each value (8 significant bits)."""
    mag = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


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
    print(json.dumps({"host_memory": meminfo()}))
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
    ptxas = ptxas_report(log)
    print(json.dumps({"ptxas": ptxas}))
    h2d = measure_h2d()
    # the template server's host pools: one buffer registered in place, the
    # weights views into it at HOST_ALIGN offsets
    from repro_torch.core.merging import HOST_ALIGN, HostBuffer
    hb = HostBuffer((256 << 20) + HOST_ALIGN)
    hb.pin()
    view = hb.view(HOST_ALIGN, (256 << 20,), torch.uint8)
    h2d_pool = measure_h2d(src=view)
    pool_view_pinned = view.is_pinned()
    hb.release()
    del hb, view
    print(f"pinned host->device copy: {h2d / 1e9:.2f} GB/s (pinned allocator), "
          f"{h2d_pool / 1e9:.2f} GB/s (a view into a registered host-pool "
          f"buffer, is_pinned {pool_view_pinned})")
    if not pool_view_pinned or h2d_pool < 0.8 * h2d:
        raise AssertionError(f"host-pool views: pinned {pool_view_pinned}, "
                             f"{h2d_pool / 1e9:.2f} GB/s against {h2d / 1e9:.2f}")
    return {"name": name, "nvidia_smi": limit, "build_s": build_s,
            "h2d_bytes_per_s": h2d, "h2d_host_pool_bytes_per_s": h2d_pool,
            "torch": torch.__version__,
            "cuda": torch.version.cuda, "ptxas": ptxas}


def demangle(names: list) -> list:
    """C++ names demangled by ``c++filt`` (or the CUDA toolkit's
    ``cu++filt``); the mangled names where neither is there."""
    for tool in ("c++filt", "/usr/local/cuda/bin/cu++filt"):
        try:
            res = subprocess.run([tool], input="\n".join(names), text=True,
                                 capture_output=True, timeout=60)
        except FileNotFoundError:
            continue
        out = res.stdout.splitlines()
        if res.returncode == 0 and len(out) == len(names):
            return out
    return list(names)


def ptxas_report(log: str, kernels=("flash_tc_kernel", "flash_fp32_kernel",
                                    "decode_split_kernel", "decode_merge_kernel",
                                    "rmsnorm_vec_kernel", "rmsnorm_scalar_kernel",
                                    "chunk_state_kernel", "state_pass_kernel",
                                    "chunk_out_kernel", "flash_bwd_dkdv_kernel",
                                    "flash_bwd_dq_kernel",
                                    "rmsnorm_bwd_dx_kernel")) -> list:
    """Registers, static shared memory and spills of the attention, rmsnorm
    and ssd_scan kernels' instantiations (and the backward kernels'), by
    source file, from ``nvcc -Xptxas -v`` in the build log."""
    entries, cur, source = [], None, None
    for line in log.splitlines():
        m = re.match(r"== (\S+) \(exit", line)
        if m:
            source, cur = m.group(1), None
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"mangled": m.group(1), "source": source}
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            cur["registers"] = int(m.group(1))
            cur["static_smem"] = int(sm.group(1)) if sm else 0
            cur = None
    rows = []
    for e, name in zip(entries, demangle([e.pop("mangled") for e in entries])):
        k = next((k for k in kernels if k in name), None)
        if k is None:
            continue
        short = name[name.index(k):]
        depth = 0
        for i, ch in enumerate(short):            # cut after the template args
            depth += {"<": 1, ">": -1}.get(ch, 0)
            if ch == ">" and depth == 0:
                short = short[:i + 1]
                break
        for long, abbr in (("(anonymous namespace)::", ""), ("__nv_bfloat16", "bf16"),
                           ("signed char", "int8"), ("float", "f32"), (" ", "")):
            short = short.replace(long, abbr)
        rows.append({"kernel": short, **e})
    return rows


def measure_h2d(nbytes: int = 256 << 20, reps: int = 5, src=None) -> float:
    """Pinned host -> device copy rate (bytes/s) of one ``nbytes`` copy on
    a side stream, as the weight streamer issues them (best of ``reps``);
    from ``src`` when given, else from a block of PyTorch's pinned
    allocator."""
    if src is None:
        src = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    nbytes = src.numel()
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.Stream()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return nbytes / best


def phase_kernels(device) -> list:
    """Every kernel against its plain version on the card, timed."""
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
                paged.append(("serving", tag, heads, 512, lengths, q_dtype, int8))
    # split-KV's own shapes, as for dense decode: one long sequence, and
    # lengths shorter than one split with a sequence of length 0
    for q_dtype, int8 in ((torch.bfloat16, False), (torch.float32, False),
                          (torch.bfloat16, True)):
        paged.append(("long", "smollm", SMOLLM, 4096, [4096], q_dtype, int8))
        paged.append(("short", "smollm", SMOLLM, 512, [0, 1, 5, 63, 64, 65, 300, 512],
                      q_dtype, int8))
    for int8 in (False, True):
        paged.append(("long", "llama3-8b", LLAMA3_8B, 4096, [4096], torch.bfloat16,
                      int8))
    for case in paged:
        results.append(paged_case(device, gen, *case))

    decode_cases = []
    for heads, tag in ((SMOLLM, "smollm"), (LLAMA3_8B, "llama3-8b"),
                       (GEMMA_2B, "gemma-2b")):
        for dtype in (torch.bfloat16, torch.float32):
            lengths = [1] + rng.integers(2, 513, 6).tolist() + [512]
            decode_cases.append(("serving", tag, heads, 512, lengths, dtype))
    # split-KV's own shapes: one long sequence (3 and 8 blocks before the
    # split), and lengths shorter than one split with a sequence of length 0
    decode_cases += [("long", "smollm", SMOLLM, 4096, [4096], torch.bfloat16),
                     ("long", "smollm", SMOLLM, 4096, [4096], torch.float32),
                     ("long", "llama3-8b", LLAMA3_8B, 4096, [4096], torch.bfloat16)]
    for dtype in (torch.bfloat16, torch.float32):
        decode_cases.append(("short", "smollm", SMOLLM, 512,
                             [0, 1, 5, 63, 64, 65, 300, 512], dtype))
    for case, tag, heads, T, lengths, dtype in decode_cases:
        results.append(decode_case(device, gen, case, tag, heads, T, lengths, dtype))

    flash_cases = []
    for heads, tag in ((SMOLLM, "smollm"), (LLAMA3_8B, "llama3-8b")):
        flash_cases += [(tag, heads, 1, 384, 384, torch.bfloat16, 0.0),
                        (tag, heads, 1, 64, 320, torch.bfloat16, 0.0),
                        (tag, heads, 1, 96, 96, torch.float32, 0.0)]
    flash_cases += [("smollm", SMOLLM, 1, 384, 384, torch.float32, 0.0),
                    ("smollm", SMOLLM, 2, 256, 256, torch.bfloat16, 30.0),
                    ("smollm", SMOLLM, 1, 200, 333, torch.float32, 30.0)]
    for tag, hd, B, S, T, dtype, softcap in flash_cases:
        results.append(flash_case(device, gen, tag, hd, B, S, T, dtype, softcap))

    for heads, tag in ((SMOLLM, "smollm"), (LLAMA3_8B, "llama3-8b"),
                       (GEMMA_2B, "gemma-2b")):
        results.append(attention_invariance(device, gen, heads, tag))

    # rmsnorm: fp32 within 1e-5 relative, bf16 within one bf16 ulp of the
    # plain version (the same fp32 value rounded; summation order only);
    # the fused form's s equals x + r and its y the unfused kernel on s,
    # bit for bit
    for tag, shape in RMSNORM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            results += rmsnorm_case(device, gen, tag, shape, dtype)
    for tag, shape, stride in STRIDED_RMSNORM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            results += rmsnorm_case(device, gen, tag, shape, dtype, stride)
    return results + big_head_cases(device)


def big_head_cases(device) -> list:
    """The attention kernels at llama2-13b's heads (40 / 40 / 128, G = 1)
    and chameleon-34b's (64 / 8 / 128): paged decode (bf16 and the int8
    arena) and dense decode at B = 8 over lengths to 512 and at B = 1,
    T = 4096, flash at S = T = 384, and the invariance checks; rmsnorm at
    their rows and chameleon's qk-norm rows is in ``RMSNORM_CASES``."""
    gen = torch.Generator().manual_seed(18)
    rng = np.random.default_rng(18)
    results = []
    for heads, tag in ((LLAMA2_13B, "llama2-13b"), (CHAMELEON_34B, "chameleon-34b")):
        lengths = [1] + rng.integers(2, 513, 6).tolist() + [512]
        for int8 in (False, True):
            for case, T, ln in (("serving", 512, lengths), ("long", 4096, [4096])):
                results.append(paged_case(device, gen, case, tag, heads, T, ln,
                                          torch.bfloat16, int8))
        for case, T, ln in (("serving", 512, lengths), ("long", 4096, [4096])):
            results.append(decode_case(device, gen, case, tag, heads, T, ln,
                                       torch.bfloat16))
        results.append(flash_case(device, gen, tag, heads, 1, 384, 384,
                                  torch.bfloat16, 0.0))
        results.append(attention_invariance(device, gen, heads, tag))
    return results


def flash_case(device, gen, tag, hd, B, S, T, dtype, softcap,
               causal: bool = True) -> dict:
    """``flash_attention`` against its plain version, timed beside SDPA
    (none with a softcap) and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn((B, hd["H"], S, hd["d"]), generator=gen).to(device, dtype)
    k = torch.randn((B, hd["KV"], T, hd["d"]), generator=gen).to(device, dtype)
    v = torch.randn((B, hd["KV"], T, hd["d"]), generator=gen).to(device, dtype)
    kw = {"causal": causal, "softcap": softcap}
    out = flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    kern_ms = time_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw))
    lib_ms = None
    if softcap == 0.0:           # SDPA has no softcap: no library call
        mask = (torch.arange(T, device=device)[None, :]
                <= torch.arange(S, device=device)[:, None] + (T - S))
        lib_kw = ({} if not causal else {"is_causal": True} if S == T
                  else {"attn_mask": mask})
        lib_ms = time_ms(lambda: sdpa_gqa(q, k, v, **lib_kw))
    flops, nbytes = flash_work(B, hd["H"], hd["KV"], S, T, hd["d"], dtype,
                               causal)
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    res = {"kernel": "flash_attention", "shape": tag, "B": B, "H": hd["H"],
           "KV": hd["KV"], "d": hd["d"], "S": S, "T": T, "causal": causal,
           "dtype": str(dtype)[6:], "softcap": softcap, "max_abs_err": err,
           "tol": tol, "ms": kern_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    if not err <= tol:
        raise AssertionError(f"flash_attention disagrees: {res}")
    return res


def unaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a view one element into rows one element wider: the same
    values, rows no longer 16-byte aligned (the kernels' element-load
    paths)."""
    wide = torch.empty(t.shape[:-1] + (t.shape[-1] + 1,), dtype=t.dtype,
                       device=t.device)[..., 1:]
    wide.copy_(t)
    return wide


def strided_rows(t: torch.Tensor, stride: int) -> torch.Tensor:
    """``t`` as the first ``t.shape[-1]`` elements of rows ``stride`` wide
    (as MLA's ``kv[..., :kvr]``): the same values, another row stride."""
    wide = torch.zeros(t.shape[:-1] + (stride,), dtype=t.dtype, device=t.device)
    wide[..., :t.shape[-1]] = t
    return wide[..., :t.shape[-1]]


def rmsnorm_case(device, gen, tag, shape, dtype, stride=None) -> list:
    """One rmsnorm case of phase 2: the kernel against its plain version,
    timed beside ``F.rms_norm``; then the residual form against its plain
    version, the add and the unfused kernel, timed beside ``x + r;
    F.rms_norm`` and ``x + r`` then the kernel.  Both forms must give the
    same bits on unaligned rows (the element-load kernel).  With
    ``stride``, x and r are rows of ``shape[-1]`` inside rows ``stride``
    wide, read in place; the case records whether the kernel takes its
    16-byte load path for them."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm, vector_path

    def within_tol(out, want) -> tuple:
        diff = (out.float() - want.float()).abs()
        if dtype == torch.float32:
            return float(diff.max()), bool((diff <= 1e-5 * want.float().abs()).all())
        return float(diff.max()), bool((diff <= bf16_ulp(want)).all())

    tol = "1e-5 relative" if dtype == torch.float32 else "1 bf16 ulp"
    x = torch.randn(shape, generator=gen).to(device, dtype)
    scale = (torch.randn(shape[-1], generator=gen) * 0.1 + 1).to(device, dtype)
    if stride:
        x = strided_rows(x, stride)
    out = rmsnorm(x, scale, 1e-5)
    same_bits = torch.equal(rmsnorm(x, scale, 1e-5), out)
    err, ok = within_tol(out, ref.rmsnorm_ref(x, scale, 1e-5))
    flops, nbytes = rmsnorm_work(shape, dtype)
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    plain = {"kernel": "rmsnorm", "shape": tag, "dims": list(shape),
             "row_stride": stride or shape[-1],
             "vector_path": vector_path(x, scale),
             "dtype": str(dtype)[6:], "max_abs_err": err, "tol": tol,
             "deterministic": same_bits,
             "unaligned_equal": torch.equal(rmsnorm(unaligned_copy(x), scale, 1e-5),
                                            out),
             "ms": time_ms(lambda: rmsnorm(x, scale, 1e-5)),
             "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, scale, 1e-5)),
             "library_ms": time_ms(lambda: F.rms_norm(x, (shape[-1],), scale, 1e-5)),
             "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(plain))
    if not (ok and same_bits and plain["unaligned_equal"] and plain["vector_path"]):
        raise AssertionError(f"rmsnorm disagrees: {plain}")

    r = torch.randn(shape, generator=gen).to(device, dtype)
    if stride:
        r = strided_rows(r, stride)
    y, s = rmsnorm(x, scale, 1e-5, residual=r)
    y2, s2 = rmsnorm(x, scale, 1e-5, residual=r)
    want_y, want_s = ref.rmsnorm_ref(x, scale, 1e-5, residual=r)
    err, ok = within_tol(y, want_y)
    y_u, s_u = rmsnorm(unaligned_copy(x), scale, 1e-5, residual=unaligned_copy(r))
    flops, nbytes = rmsnorm_work(shape, dtype, residual=True)
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    fused = {"kernel": "rmsnorm[residual]", "shape": tag, "dims": list(shape),
             "row_stride": stride or shape[-1],
             "vector_path": vector_path(x, scale, r),
             "dtype": str(dtype)[6:], "max_abs_err": err, "tol": tol,
             "s_equals_add": torch.equal(s, x + r) and torch.equal(s, want_s),
             "y_equals_kernel_on_add": torch.equal(y, rmsnorm(x + r, scale, 1e-5)),
             "deterministic": torch.equal(y, y2) and torch.equal(s, s2),
             "unaligned_equal": torch.equal(y_u, y) and torch.equal(s_u, s),
             "ms": time_ms(lambda: rmsnorm(x, scale, 1e-5, residual=r)),
             "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, scale, 1e-5, residual=r)),
             "add_then_library_ms": time_ms(
                 lambda: F.rms_norm(x + r, (shape[-1],), scale, 1e-5)),
             "add_then_kernel_ms": time_ms(lambda: rmsnorm(x + r, scale, 1e-5)),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(fused))
    if not (ok and fused["s_equals_add"] and fused["y_equals_kernel_on_add"]
            and fused["deterministic"] and fused["unaligned_equal"]
            and fused["vector_path"]):
        raise AssertionError(f"fused rmsnorm differs from its plain version, the "
                             f"add or the unfused kernel: {fused}")
    return [plain, fused]


def paged_case(device, gen, case, tag, hd, max_len, lengths, q_dtype,
               int8) -> dict:
    """``paged_decode_attention`` against its plain version over a shuffled
    arena of 8-row pages, timed beside gather + SDPA (the arena
    dequantized first for int8) and the bound.  A sequence of length 0
    must give exact zeros, the others agree within the tolerance."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    B = len(lengths)
    c = make_paged_case(gen, B, hd["H"], hd["KV"], hd["d"], PAGE_SIZE, max_len,
                        lengths, q_dtype, int8, device)
    args = (c["q"], c["k_pages"], c["v_pages"], c["page_table"], c["lengths"])
    kw = {"k_scales": c["k_scales"], "v_scales": c["v_scales"]}
    out = paged_decode_attention(*args, **kw)
    want = ref.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    live = c["lengths"] > 0
    err = float((out.float() - want.float())[live].abs().max())
    empty_zero = bool((out[~live] == 0).all())
    tol = 2e-5 if q_dtype == torch.float32 else 2e-2
    kern_ms = time_ms(lambda: paged_decode_attention(*args, **kw))
    plain_ms = time_ms(lambda: ref.paged_decode_attention_ref(*args, **kw))
    T = c["page_table"].shape[1] * PAGE_SIZE
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
    res = {"kernel": "paged_decode_attention", "case": case, "shape": tag, "B": B,
           "H": hd["H"], "KV": hd["KV"], "d": hd["d"], "ps": PAGE_SIZE,
           "max_len": int(max(lengths)),
           "lengths": list(lengths) if case == "short" else None,
           "q_dtype": str(q_dtype)[6:], "kv_dtype": str(kv_dtype)[6:],
           "max_abs_err": err, "tol": tol,
           "length0_zero": empty_zero if not live.all() else None,
           "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    if not (err <= tol and empty_zero):
        raise AssertionError(f"paged_decode_attention disagrees: {res}")
    return res


def decode_case(device, gen, case, tag, heads, T, lengths, dtype) -> dict:
    """``decode_attention`` against its plain version over a [B, T, KV, d]
    cache view, timed beside SDPA and the bound.  A sequence of length 0
    must give exact zeros (as the Pallas kernel does; the plain version's
    softmax over no rows is uniform instead), the others agree within the
    tolerance."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    B, H, KV, d = len(lengths), heads["H"], heads["KV"], heads["d"]
    q = torch.randn((B, H, d), generator=gen).to(device, dtype)
    ck = torch.randn((B, T, KV, d), generator=gen).to(device, dtype)
    cv = torch.randn((B, T, KV, d), generator=gen).to(device, dtype)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)   # the cache view
    out = decode_attention(q, k, v, ln)
    want = ref.decode_attention_ref(q, k, v, ln)
    torch.cuda.synchronize()
    live = ln > 0
    err = float((out.float() - want.float())[live].abs().max())
    empty_zero = bool((out[~live] == 0).all())
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    kern_ms = time_ms(lambda: decode_attention(q, k, v, ln))
    plain_ms = time_ms(lambda: ref.decode_attention_ref(q, k, v, ln))
    mask = (torch.arange(T, device=device)[None, :]
            < ln[:, None].long())[:, None, None, :]
    lib_ms = time_ms(lambda: sdpa_gqa(q[:, :, None], k, v, attn_mask=mask))
    flops, nbytes = decode_work(B, H, KV, d, lengths, dtype)
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    res = {"kernel": "decode_attention", "case": case, "shape": tag, "B": B,
           "H": H, "KV": KV, "d": d, "T": T, "max_len": int(max(lengths)),
           "lengths": list(lengths) if case == "short" else None,
           "dtype": str(dtype)[6:], "max_abs_err": err, "tol": tol,
           "length0_zero": empty_zero if not live.all() else None,
           "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    if not (err <= tol and empty_zero):
        raise AssertionError(f"decode_attention disagrees: {res}")
    return res


def attention_invariance(device, gen, heads: dict, tag: str) -> dict:
    """Bitwise checks of the attention kernels that serving relies on (a
    fork's full prefill against a warm suffix prefill over the baked
    prefix; a sequence decoded alone or in a batch; the paged and the
    dense pool giving the same tokens): in bf16 a suffix prefill's rows
    equal the last rows of the whole prefill over the same K/V, a sequence
    alone equals it inside a batch of other prompts or lengths, and a
    repeated call equals the first; in bf16 and fp32 paged decode over a
    shuffled arena of 8-row pages equals dense decode over a cache built
    from the pages the table selects, at ragged lengths from 0 to 512."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention
    H, KV, d, bf = heads["H"], heads["KV"], heads["d"], torch.bfloat16
    T, S = 320, 64
    q = torch.randn((4, H, T, d), generator=gen).to(device, bf)
    k = torch.randn((4, KV, T, d), generator=gen).to(device, bf)
    v = torch.randn((4, KV, T, d), generator=gen).to(device, bf)
    full = flash_attention(q, k, v)
    res = {"flash_suffix_equals_prefill": torch.equal(
               flash_attention(q[:, :, T - S:], k, v), full[:, :, T - S:]),
           "flash_alone_equals_batch": torch.equal(
               flash_attention(q[2:3], k[2:3], v[2:3]), full[2:3]),
           "flash_repeat_equal": torch.equal(flash_attention(q, k, v), full)}
    T = 512
    lengths = [300, 1, 64, 0, 129, 512, 17, 250]
    q = torch.randn((8, H, d), generator=gen).to(device, bf)
    ck = torch.randn((8, T, KV, d), generator=gen).to(device, bf)
    cv = torch.randn((8, T, KV, d), generator=gen).to(device, bf)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    kc, vc = ck.transpose(1, 2), cv.transpose(1, 2)
    out = decode_attention(q, kc, vc, ln)
    res["decode_alone_equals_batch"] = all(
        torch.equal(decode_attention(q[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                                     ln[b:b + 1]), out[b:b + 1]) for b in (0, 4, 6))
    res["decode_repeat_equal"] = torch.equal(decode_attention(q, kc, vc, ln), out)
    lengths = [0, 1, 5, 63, 64, 65, 300, 512]
    for dtype in (bf, torch.float32):
        c = make_paged_case(gen, 8, H, KV, d, PAGE_SIZE, T, lengths, dtype, False,
                            device)
        args = (c["q"], c["k_pages"], c["v_pages"], c["page_table"], c["lengths"])
        pt = c["page_table"].long()
        kd = c["k_pages"][pt].reshape(8, T, KV, d).transpose(1, 2)
        vd = c["v_pages"][pt].reshape(8, T, KV, d).transpose(1, 2)
        out = paged_decode_attention(*args)
        name = str(dtype)[6:]
        res[f"paged_equals_dense_{name}"] = torch.equal(
            out, decode_attention(c["q"], kd, vd, c["lengths"]))
        if dtype == bf:
            qb, kp, vp, ptb, lb = args
            res["paged_alone_equals_batch"] = all(
                torch.equal(paged_decode_attention(qb[b:b + 1], kp, vp, ptb[b:b + 1],
                                                   lb[b:b + 1]), out[b:b + 1])
                for b in (2, 4, 6, 7))
            res["paged_repeat_equal"] = torch.equal(paged_decode_attention(*args), out)
    row = {"invariance": tag, **res}
    print(json.dumps(row))
    if not all(res.values()):
        raise AssertionError(f"attention invariance broken: {row}")
    return row


def attention_launches(cfg) -> int:
    """Attention blocks of one model call: one per layer, or for zamba one
    per application of the shared block, none for xlstm.  Each GQA block
    launches one attention kernel; an MLA block none (see
    ``attention_kernels``)."""
    if cfg.family == "zamba":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "xlstm":
        return 0
    return cfg.n_layers


def xlstm_blocks(cfg) -> tuple:
    """xlstm: (mLSTM blocks, sLSTM blocks) of the model: a unit of
    ``slstm_every`` layers holds ``slstm_every - 1`` mLSTM blocks and one
    sLSTM block (42 and 6 for xlstm-1.3b)."""
    units = cfg.n_layers // cfg.slstm_every
    return units * (cfg.slstm_every - 1), units


def attention_kernels(cfg) -> int:
    """Attention kernel launches of one model call: MLA attends in PyTorch
    ops (the reference runs it outside any Pallas kernel), so none."""
    return 0 if cfg.use_mla else attention_launches(cfg)


def norm_launches(cfg) -> int:
    """rmsnorm launches of one model call: two per block, the final norm,
    and two more per block for qk-norm models or MLA models (``q_a_norm``
    and ``kv_a_norm``).  zamba: two per Mamba2 block (the pre-norm and the
    mixer's gated norm), two per application of the shared block, and the
    final norm (127 for zamba2-2.7b).  xlstm: two per mLSTM block (the
    pre-norm and the inner norm), three per sLSTM block (the pre-norm, the
    inner norm and ``mlp_norm``), and the final norm (103 for
    xlstm-1.3b)."""
    if cfg.family == "zamba":
        return 2 * cfg.n_layers + 2 * attention_launches(cfg) + 1
    if cfg.family == "xlstm":
        n_m, n_s = xlstm_blocks(cfg)
        return 2 * n_m + 3 * n_s + 1
    return (4 if cfg.qk_norm or cfg.use_mla else 2) * cfg.n_layers + 1


def fused_norm_launches(cfg) -> int:
    """rmsnorm launches of one model call with the residual add fused in:
    the pre-MLP norm of every attention + MLP block (``_dense_block``), so
    one per attention launch (30 for smollm-135m, 9 for zamba2-2.7b's
    shared block); for xlstm the ``mlp_norm`` of every sLSTM block (6 for
    xlstm-1.3b).  They are counted under ``rmsnorm`` too."""
    if cfg.family == "xlstm":
        return xlstm_blocks(cfg)[1]
    return attention_launches(cfg)


def check_norm_launches(counts: dict, cfg, where: str) -> None:
    """Every model call launches attention_kernels(cfg) attention kernels,
    norm_launches(cfg) rmsnorms and fused_norm_launches(cfg) fused ones, so
    the counts stand in fixed ratios (MLA and xlstm: no attention kernel,
    and the fused launches count the calls; xlstm: no ``ssd_scan``
    either)."""
    attn = (counts["paged_decode_attention"] + counts["flash_attention"]
            + counts["decode_attention"])
    units = attention_kernels(cfg)
    if cfg.use_mla or cfg.family == "xlstm":
        attn, units = counts["rmsnorm_fused"], fused_norm_launches(cfg)
        if counts["paged_decode_attention"] or counts["flash_attention"] or (
                counts["decode_attention"]) or not attn or (
                cfg.family == "xlstm" and counts["ssd_scan"]):
            raise AssertionError(f"{where}: {cfg.name} launched {counts}")
    if (counts["rmsnorm"] * units != norm_launches(cfg) * attn
            or counts["rmsnorm_fused"] * units != fused_norm_launches(cfg) * attn):
        raise AssertionError(f"{where}: rmsnorm launches {counts} are not "
                             f"{norm_launches(cfg)} ({fused_norm_launches(cfg)} "
                             f"fused) per {units} attention launches")


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


def full_model(device, seed: int = 0):
    """smollm-135m at full width and depth with seeded random weights."""
    from repro_torch.models.registry import get_model
    model = get_model("smollm-135m", device=device)
    assert model.cfg.n_layers == SERVE_LAYERS and model.cfg.d_model == 576
    t0 = time.perf_counter()
    params = model.init_params(seed=seed)
    torch.cuda.synchronize()
    print(f"smollm-135m: {model.cfg.n_layers} layers, d_model "
          f"{model.cfg.d_model}, {model.dtype}, weights (seed {seed}) in "
          f"{time.perf_counter() - t0:.1f} s")
    return model, params


SERVE_PASSES = (("paged", {}), ("chunked", {"chunk_tokens": 64}),
                ("int8", {"kv_dtype": "int8"}))


def phase_serve(model, params, passes=SERVE_PASSES) -> tuple:
    """A model at full width through the paged continuous-batching engine
    over the serving workload (smollm-135m: plain, chunked-prefill and
    int8-arena passes), after a warm-up of two requests.  Launch counts
    are exact per pass; each row records how many of its tokens equal the
    first pass's.  Returns the passes' rows and the first pass's
    tokens."""
    from repro_torch.kernels import ops
    vocab, L = model.cfg.vocab_size, attention_kernels(model.cfg)
    prefix, reqs = serving_workload(vocab)
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
        if counts["paged_decode_attention"] != eng.n_decode_steps * L:
            raise AssertionError(f"{name}: paged decode launches {counts} != "
                                 f"{eng.n_decode_steps} steps x {L}")
        if counts["flash_attention"] != eng.n_prefill_calls * L:
            raise AssertionError(f"{name}: flash launches {counts} != "
                                 f"{eng.n_prefill_calls} prefills x {L}")
        calls = eng.n_decode_steps + eng.n_prefill_calls
        if (counts["rmsnorm"] != calls * norm_launches(model.cfg)
                or counts["rmsnorm_fused"] != calls * fused_norm_launches(model.cfg)):
            raise AssertionError(f"{name}: rmsnorm launches {counts} != "
                                 f"{calls} model calls x {norm_launches(model.cfg)} "
                                 f"({fused_norm_launches(model.cfg)} fused)")
        hits = sum(r.reused_prefix_len > 0 for r in res)
        if hits < 2 or pool.stats["shared_pages_mapped"] < 2 * (128 // PAGE_SIZE):
            raise AssertionError(f"{name}: prefix hits {hits}, {pool.stats}")
        ttft = np.asarray([r.ttft_s for r in res]) * 1e3
        e2e = np.asarray([r.e2e_s for r in res]) * 1e3
        n_tok = sum(r.n_generated for r in res)
        tokens_by_pass[name] = [r.tokens for r in res]
        row = {"pass": name, "arch": model.cfg.name, "requests": len(res),
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
    base = tokens_by_pass[passes[0][0]]
    for row in out:
        same = sum(int((a == b).sum())
                   for a, b in zip(base, tokens_by_pass[row["pass"]]))
        row["tokens_equal_to_first_pass"] = f"{same}/{16 * len(base)}"
        print(f"{model.cfg.name} tokens equal to the {passes[0][0]} pass: "
              f"{row['pass']} {same}/{16 * len(base)}")
    return out, base


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
    res["engine"] = engine_parity(cfg, device)
    res["streamed_prefill_equal"] = streamed_parity(cfg, device)
    return res


def engine_parity(cfg, device) -> dict:
    """The sequential ``Engine`` (dense cache: flash prefill, then the
    decode_attention kernel) on the card against the CPU."""
    from repro_torch.models.registry import get_model
    from repro_torch.runtime import Engine
    prompts = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 40)
                                                ).astype(np.int32)
    runs = {}
    for dev in (device, "cpu"):
        model = get_model(cfg, device=dev)
        logits = []

        def prefill(p, inputs, cache, m=model, out=logits):
            lg, cache = m.prefill(p, inputs, cache)
            out.append(lg.float().cpu())
            return lg, cache

        def decode(p, cache, inputs, pos, m=model, out=logits):
            lg, cache = m.decode_step(p, cache, inputs, pos)
            out.append(lg.float().cpu())
            return lg, cache

        res = Engine(model, model.init_params(seed=1), prefill, decode
                     ).generate(prompts, max_new_tokens=8)
        runs[str(dev)] = (torch.stack(logits), res.tokens)
    (lg_gpu, tk_gpu), (lg_cpu, tk_cpu) = runs[str(device)], runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    out = {"max_abs_logit_err": err, "tol": 1e-3,
           "tokens_equal": bool((tk_gpu == tk_cpu).all())}
    print(json.dumps({"engine_parity": out}))
    if not err <= 1e-3 or not out["tokens_equal"]:
        raise AssertionError(f"Engine card vs CPU parity failed: {out}")
    return out


def streamed_parity(cfg, device) -> bool:
    """A forked session's layer-streamed prefill on the card equals the
    monolithic prefill bit for bit (logits and cache)."""
    from repro_torch.core import api as tidal
    from repro_torch.core.streaming import streamed_prefill
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.models.registry import get_model
    model = get_model(cfg, device=device)
    params = model.init_params(seed=1)
    srv = TemplateServer(trace_seq=64)
    srv.register(tidal.static_function("f", model, params), {})
    session, _ = srv.fork("f", {})
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (1, 100)
                                             ).astype(np.int32)
    lg_s, c_s = streamed_prefill(session, {"tokens": toks},
                                 model.make_cache(1, 128))
    lg_m, c_m = model.prefill(params, {"tokens": toks}, model.make_cache(1, 128))
    torch.cuda.synchronize()
    equal = (torch.equal(lg_s, lg_m)
             and all(torch.equal(c_s[k], c_m[k]) for k in c_s))
    print(f"streamed prefill on the card equals the monolithic one: {equal}")
    if not equal:
        raise AssertionError("streamed prefill differs from prefill on the card")
    return equal


def phase_engine(model, params, paged_tokens: list) -> list:
    """The dense-cache paths at full width: the sequential ``Engine`` (8
    prompts of 256 tokens, 32 new tokens), then ``paged=False`` continuous
    batching over phase 3's workload."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import ContinuousBatchingEngine, Engine
    L, vocab = model.cfg.n_layers, model.cfg.vocab_size
    prompts = np.random.default_rng(5).integers(1, vocab, (8, 256)
                                                ).astype(np.int32)
    eng = Engine(model, params)
    eng.generate(prompts[:, :32], max_new_tokens=2)          # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_norm, n_fused = norm_launches(model.cfg), fused_norm_launches(model.cfg)
    if (counts["decode_attention"] != L * 31 or counts["flash_attention"] != L
            or counts["rmsnorm"] != 32 * n_norm
            or counts["rmsnorm_fused"] != 32 * n_fused):
        raise AssertionError(f"Engine launches {counts}, want {L * 31} decode, "
                             f"{L} flash and {32 * n_norm} rmsnorm "
                             f"({32 * n_fused} fused)")
    if res.tokens.shape != (8, 32) or not ((res.tokens >= 0)
                                           & (res.tokens < vocab)).all():
        raise AssertionError(f"Engine tokens {res.tokens.shape}")
    rows = [{"pass": "engine", "batch": 8, "prompt_len": 256, "new_tokens": 32,
             "launches": counts, "wall_s": wall, "ttft_ms": res.ttft_s * 1e3,
             "decode_ms_per_step": res.decode_s / 31 * 1e3,
             "tokens_per_s": 8 * 32 / wall}]
    print(json.dumps(rows[-1]))

    _, reqs = serving_workload(vocab)
    cbe = ContinuousBatchingEngine(model, params, n_slots=8, max_len=512,
                                   paged=False)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ids = [cbe.submit(p, 16) for p in reqs]
    results = cbe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    out = [results[i] for i in ids]
    if any(r.status != "done" or r.n_generated != 16 for r in out):
        raise AssertionError("dense pass: unfinished requests")
    if (counts["decode_attention"] != L * cbe.n_decode_steps
            or counts["flash_attention"] != L * cbe.n_prefill_calls
            or counts["rmsnorm"] != n_norm * (cbe.n_decode_steps
                                              + cbe.n_prefill_calls)
            or counts["rmsnorm_fused"] != n_fused * (cbe.n_decode_steps
                                                     + cbe.n_prefill_calls)
            or counts["paged_decode_attention"]):
        raise AssertionError(f"dense pass launches {counts}, steps "
                             f"{cbe.n_decode_steps}, prefills {cbe.n_prefill_calls}")
    same = sum(int((r.tokens == t).sum()) for r, t in zip(out, paged_tokens))
    ttft = np.asarray([r.ttft_s for r in out]) * 1e3
    rows.append({"pass": "dense", "requests": len(out),
                 "decode_steps": cbe.n_decode_steps,
                 "prefill_calls": cbe.n_prefill_calls, "launches": counts,
                 "wall_s": wall, "tokens_per_s": 16 * len(out) / wall,
                 "ttft_ms_p50": float(np.percentile(ttft, 50)),
                 "ttft_ms_max": float(ttft.max()),
                 "tokens_equal_to_paged_pass": same})
    print(json.dumps(rows[-1]))
    print(f"dense pass tokens equal to the paged pass: {same}/{16 * len(out)}")
    # paged and dense decode run one split-KV body, so the two pools give
    # the same greedy tokens
    if same != 16 * len(out):
        raise AssertionError(f"dense pass: {same}/{16 * len(out)} tokens equal "
                             f"to the paged pass")
    return rows


def _median_max(xs) -> dict:
    xs = np.asarray(xs, dtype=float) * 1e3
    return {"n": int(xs.size), "median_ms": float(np.median(xs)),
            "max_ms": float(xs.max())}


def phase_tidal(device, h2d: float) -> dict:
    """``FaaSRuntime`` at full width: a static function with a 131-token
    template prompt and a LoRA function (``blocks.attn.wq``, 2 adapters),
    invoked through the gateway's pump thread so that each is cold once,
    then warm, then forked after an evict (the LoRA one also on a new
    event)."""
    from repro_torch.core import api as tidal
    from repro_torch.core.forking import DonationGuard
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.runtime import FaaSRuntime, InvocationRequest
    model, p_static = full_model(device, seed=2)
    p_lora = model.init_params(seed=3)
    vocab = model.cfg.vocab_size
    prefix, reqs = serving_workload(vocab)
    rt = FaaSRuntime(server=TemplateServer(hw=H100_SXM.with_h2d(h2d),
                                           trace_seq=128),
                     n_slots=8, max_len=512, page_size=PAGE_SIZE, device=device)
    t0 = time.perf_counter()
    rt.deploy(tidal.static_function("static", model, p_static), {},
              prewarm_seq=128, template_prompt=prefix)
    rt.deploy(tidal.lora_function("lora", model, p_lora, ["blocks.attn.wq"],
                                  n_adapters=2), {"adapter": "adapter-0"},
              prewarm_seq=128)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    model_bytes = rt.server.templates["static"].total_bytes
    a0, a1 = {"adapter": "adapter-0"}, {"adapter": "adapter-1"}
    # (function, event, prompt index): the first of each key forks its engine
    waves = [[("static", {}, 0), ("static", {}, 1), ("lora", a0, 3),
              ("lora", a0, 4)],
             [("static", {}, 2), ("lora", a0, 5), ("lora", a1, 6),
              ("lora", a1, 7)],
             "evict",
             [("static", {}, 0), ("lora", a1, 6)],
             [("static", {}, 0), ("lora", a1, 6), ("static", {}, 8),
              ("lora", a0, 9), ("lora", a0, 10), ("static", {}, 11)]]
    results, stats, guard_bufs = [], [], None
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rt.gateway.start_pump()
    try:
        for wave in waves:
            if wave == "evict":
                rt.evict()
                # make half the static template resident, so the next fork
                # shares device buffers the guard then watches
                rt.server.set_resident_bytes("static", model_bytes // 2)
                guard_bufs = dict(rt.server.device_cache["static"])
                guard = DonationGuard.guard(guard_bufs)
                continue
            handles = [rt.submit(InvocationRequest(fn, reqs[i], event=ev,
                                                   max_new_tokens=16))
                       for fn, ev, i in wave]
            for (fn, ev, i), h in zip(wave, handles):
                r = h.result(timeout=600)
                results.append((fn, tuple(sorted(ev.items())), i, r))
                if r.fork_stats is not None:
                    eng = rt._engines[h.engine_key].engine
                    stats.append((fn, r.fork_stats, eng.session.streamer))
    finally:
        rt.gateway.stop_pump()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    kinds = [r.kind for *_, r in results]
    if set(kinds) != {"cold", "warm", "fork"}:
        raise AssertionError(f"service kinds {kinds}")
    bad = [r for *_, r in results if r.status != "done" or len(r.tokens) != 16]
    if bad:
        raise AssertionError(f"unfinished invocations {bad}")
    first_of_engine = [r for *_, r in results if r.fork_stats is not None]
    if not all(r.streamed_prefill for r in first_of_engine):
        raise AssertionError("a cold/fork admission did not stream its prefill")
    for fn, fs, streamer in stats:
        if fs.reused_bytes + fs.streamed_bytes + fs.dynamic_bytes != model_bytes:
            raise AssertionError(f"{fn}: fork bytes {fs} != {model_bytes}")
        streamer.wait_all()
        rank = {k: j for j, k in enumerate(rt.server.templates[fn].order)}
        done = [rank[k] for k in streamer.completed_order]
        if (streamer.completed_order != [e.key for e in streamer.entries]
                or done != sorted(done)):
            raise AssertionError(f"{fn}: stream order differs from the template")
    reused = [fs.reused_bytes for fn, fs, _ in stats if fn == "static"]
    violated = guard.check(guard_bufs)
    if not guard_bufs or not reused[-1] or violated:
        raise AssertionError(f"forking guard: {len(guard_bufs)} buffers, "
                             f"reused {reused}, violated {violated}")
    # a fork's tokens equal a warm invocation's for the same prompt/event
    by_key = {}
    for fn, ev, i, r in results[-8:]:
        by_key.setdefault((fn, ev, i), []).append(r)
    for key, rs in by_key.items():
        if len(rs) == 2 and rs[0].kind == "fork":
            if rs[1].kind != "warm" or not np.array_equal(rs[0].tokens,
                                                          rs[1].tokens):
                raise AssertionError(f"{key}: fork tokens != warm tokens")
    if (counts["paged_decode_attention"] == 0 or counts["flash_attention"] == 0
            or counts["decode_attention"]):
        raise AssertionError(f"TIDAL phase launches {counts}")
    check_norm_launches(counts, model.cfg, "TIDAL phase")
    out = {"deploy_s": deploy_s, "model_bytes": model_bytes,
           "invocations": len(results), "kinds": kinds, "wall_s": wall,
           "launches": counts,
           "ttft": {k: _median_max([r.ttft_s for *_, r in results
                                    if r.kind == k])
                    for k in ("cold", "fork", "warm")},
           "fork_s": _median_max([fs.fork_s for _, fs, _ in stats]),
           "fork_bytes": [{"fn": fn, "reused": fs.reused_bytes,
                           "streamed": fs.streamed_bytes,
                           "dynamic": fs.dynamic_bytes} for fn, fs, _ in stats],
           "reuse_hits": sum(r.reused_prefix_len > 0 for *_, r in results),
           "h2d_gb_per_s": h2d / 1e9,
           "resident_bytes_after_eq1": {k: t.resident_bytes for k, t
                                        in rt.server.templates.items()},
           "gateway": dict(rt.gateway.stats)}
    out["isolated"] = isolated_fork_and_warm(rt, reqs[0])
    print(json.dumps(out))
    rt.evict()
    out["first_invocation"] = {
        mode: first_ttft_subprocess(mode) for mode in ("prewarm", "no-prewarm")}
    print(json.dumps({"first_invocation": out["first_invocation"]}))
    return out


def isolated_fork_and_warm(rt, prompt) -> dict:
    """One invocation alone on a fresh fork, then the same one warm: the
    paper's fork-against-warm TTFT with no other request queued."""
    rt.evict()
    fork = rt.submit("static", {}, prompt, 16)
    warm = rt.submit("static", {}, prompt, 16)
    if (fork.kind, warm.kind) != ("fork", "warm") or not np.array_equal(
            fork.tokens, warm.tokens):
        raise AssertionError(f"isolated pair: {fork.kind} {warm.kind}")
    return {"fork_ttft_ms": fork.ttft_s * 1e3, "warm_ttft_ms": warm.ttft_s * 1e3,
            "fork_s_ms": fork.fork_stats.fork_s * 1e3,
            "streamed_prefill": fork.streamed_prefill,
            "reused_prefix_len": fork.reused_prefix_len}


def first_ttft_subprocess(mode: str) -> dict:
    """The first invocation's TTFT in a fresh process (context, library
    load and first calls unpaid), with or without deploy-time prewarming."""
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--first-ttft", mode], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"--first-ttft {mode} failed:\n{res.stdout}"
                           f"{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def first_ttft(mode: str) -> dict:
    """Body of ``--first-ttft``: deploy one static smollm-135m function and
    time its first invocation (256-token prompt, 8 new tokens)."""
    from repro_torch.core import api as tidal
    from repro_torch.runtime import FaaSRuntime
    device = torch.device("cuda", 0)
    model, params = full_model(device, seed=2)
    t0 = time.perf_counter()
    rt = FaaSRuntime(n_slots=8, max_len=512, page_size=PAGE_SIZE,
                     prewarm=mode == "prewarm", device=device)
    runtime_s = time.perf_counter() - t0
    fn = tidal.static_function("f", model, params)
    t0 = time.perf_counter()
    rt.server.register(fn, {})
    register_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt.deploy(fn, {}, prewarm_seq=256)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    prompt = np.random.default_rng(6).integers(1, model.cfg.vocab_size, 256)
    r = rt.submit("f", {}, prompt.astype(np.int32), 8)
    second = rt.submit("f", {}, prompt.astype(np.int32), 8)
    return {"mode": mode, "runtime_s": runtime_s, "register_s": register_s,
            "deploy_s": deploy_s, "kind": r.kind,
            "ttft_ms": r.ttft_s * 1e3, "e2e_ms": r.e2e_s * 1e3,
            "warm_ttft_ms": second.ttft_s * 1e3}


TENANT_TARGETS = ("blocks.attn.wq", "blocks.attn.wv")
TENANT_ALPHAS = {"fn-1": 0.5, "fn-2": 1.0, "fn-3": 1.5}


def _tenant_checkpoints(model, rank: int = 8) -> dict:
    from repro_torch.core import api as tidal
    return {name: tidal.lora_checkpoint(f"ckpt://{name}", model,
                                        list(TENANT_TARGETS), rank=rank, seed=i)
            for i, name in enumerate(TENANT_ALPHAS, start=1)}


def phase_tenants(device, h2d: float) -> dict:
    """Many LoRA functions on one resident base at full width: a shared
    smollm-135m base (bank of 4 rows over wq and wv, rank 8) serving three
    adapter functions and the base itself through the gateway's pump
    thread; then the merged-weight check and the control plane."""
    from repro_torch.core import api as tidal
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.runtime import FaaSRuntime, InvocationRequest
    model, p_base = full_model(device, seed=4)
    vocab, L = model.cfg.vocab_size, model.cfg.n_layers
    rt = FaaSRuntime(server=TemplateServer(hw=H100_SXM.with_h2d(h2d),
                                           trace_seq=128),
                     n_slots=8, max_len=512, page_size=PAGE_SIZE, device=device)
    t0 = time.perf_counter()
    rt.deploy_shared_base(tidal.static_function("base", model, p_base),
                          n_adapters=4, rank=8, target_paths=TENANT_TARGETS,
                          prewarm_seq=128)
    for name, ckpt in _tenant_checkpoints(model).items():
        rt.attach_adapter(name, "base", ckpt, alpha=TENANT_ALPHAS[name])
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    names = ["base"] + list(TENANT_ALPHAS)
    work = [(names[i % 4], rng.integers(1, vocab, int(rng.integers(64, 257))
                                        ).astype(np.int32)) for i in range(16)]
    # record the adapter rows of every banked decode step
    mixes = []
    decode_step_paged = model.decode_step_paged

    def recording(*a, **kw):
        if kw.get("adapter_bank") is not None:
            ids = set(kw["adapter_ids"].tolist()) - {0}
            mixes.append(len(ids))
        return decode_step_paged(*a, **kw)

    model.decode_step_paged = recording
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rt.gateway.start_pump()
    try:
        handles = [rt.submit(InvocationRequest(fn, p, max_new_tokens=16))
                   for fn, p in work]
        res = [h.result(timeout=600) for h in handles]
    finally:
        rt.gateway.stop_pump()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    del model.decode_step_paged

    key = ("__adapters__", "base", 0)
    rows = dict(rt._engines[key].adapter_ids)
    if sorted(rows) != sorted(TENANT_ALPHAS) or sorted(rows.values()) != [1, 2, 3]:
        raise AssertionError(f"adapter rows {rows}")
    bad = [r for r in res if r.status != "done" or len(r.tokens) != 16
           or not ((r.tokens >= 0) & (r.tokens < vocab)).all()]
    if bad:
        raise AssertionError(f"unfinished tenant invocations {bad}")
    if not mixes or max(mixes) < 2:
        raise AssertionError(f"no decode step mixed adapter rows: {mixes}")
    engines = [w.engine for w in rt._engines.values()]
    steps = sum(e.n_decode_steps for e in engines)
    prefills = sum(e.n_prefill_calls for e in engines)
    if (counts["paged_decode_attention"] != L * steps
            or counts["flash_attention"] != L * prefills
            or counts["rmsnorm"] != norm_launches(model.cfg) * (steps + prefills)
            or counts["rmsnorm_fused"] != fused_norm_launches(model.cfg) * (
                steps + prefills)
            or counts["decode_attention"]):
        raise AssertionError(f"tenant launches {counts}, {steps} decode steps, "
                             f"{prefills} prefills")
    out = {"deploy_s": deploy_s, "invocations": len(res),
           "engines": [list(map(str, k)) for k in rt.warm_engines()],
           "adapter_rows": rows, "decode_steps": steps, "prefill_calls": prefills,
           "banked_steps": len(mixes), "mixed_steps": sum(m >= 2 for m in mixes),
           "max_rows_in_a_step": max(mixes), "launches": counts, "wall_s": wall,
           "tokens_per_s": 16 * len(res) / wall,
           "kinds": [r.kind for r in res],
           "ttft": {fn: _median_max([r.ttft_s for (f, _), r in zip(work, res)
                                     if f == fn]) for fn in names}}
    print(json.dumps(out))
    out["merged_parity"] = merged_parity(device)
    out["control_plane"] = control_plane_run(rt, model, p_base)
    return out


def merged_parity(device) -> dict:
    """2-layer fp32 smollm-135m at full width on the card: each adapter
    function's greedy tokens from one mixed banked batch equal its
    merged-weight model's (W + alpha * A @ B), and their last-token logits
    agree within 1e-3 (different fp32 arithmetic, TF32 off)."""
    from repro_torch.models.adapters import load_adapter, make_adapter_bank
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.runtime import ContinuousBatchingEngine, Engine
    cfg = get_config("smollm-135m").replace(n_layers=2, dtype="float32")
    model = get_model(cfg, device=device)
    params = model.init_params(seed=1)
    ckpts = _tenant_checkpoints(model)
    bank = make_adapter_bank(model, TENANT_TARGETS, 4, 8)
    for row, (name, ckpt) in enumerate(ckpts.items(), start=1):
        load_adapter(bank, row, ckpt, model, alpha=TENANT_ALPHAS[name])
    prompts = np.random.default_rng(8).integers(1, cfg.vocab_size, (3, 40)
                                                ).astype(np.int32)
    eng = ContinuousBatchingEngine(model, params, n_slots=4, max_len=64,
                                   page_size=PAGE_SIZE, adapter_bank=bank)
    ids = [eng.submit(p, 8, adapter_id=row) for row, p in enumerate(prompts, 1)]
    got = eng.run()
    out, worst = {}, 0.0
    for row, (name, ckpt) in enumerate(ckpts.items(), start=1):
        merged = {**params, "layers": [dict(lp, attn=dict(lp["attn"]))
                                       for lp in params["layers"]]}
        for path in TENANT_TARGETS:
            proj = path.rsplit(".", 1)[-1]
            a, b = ckpt.arrays[path + ".A"], ckpt.arrays[path + ".B"]
            delta = ((a @ b) * TENANT_ALPHAS[name]).reshape(cfg.n_layers, *merged[
                "layers"][0]["attn"][proj].shape)
            for i, lp in enumerate(merged["layers"]):
                lp["attn"][proj] = lp["attn"][proj] + delta[i].to(device)
        want = Engine(model, merged).generate(prompts[row - 1][None],
                                              max_new_tokens=8).tokens[0]
        toks = got[ids[row - 1]].tokens
        seq = np.concatenate([prompts[row - 1], toks[:-1]])[None]
        lg_bank, _ = model.prefill(params, {"tokens": seq}, model.make_cache(1, 64),
                                   adapter_bank=bank, adapter_ids=[row])
        lg_merged, _ = model.prefill(merged, {"tokens": seq}, model.make_cache(1, 64))
        err = float((lg_bank - lg_merged).abs().max())
        worst = max(worst, err)
        out[name] = {"tokens_equal": bool(np.array_equal(toks, want)),
                     "max_abs_logit_err": err}
    res = {"functions": out, "tol": 1e-3, "max_abs_logit_err": worst}
    print(json.dumps({"merged_parity": res}))
    if worst > 1e-3 or not all(v["tokens_equal"] for v in out.values()):
        raise AssertionError(f"banked adapters differ from merged weights: {res}")
    return res


def control_plane_run(rt, model, params) -> dict:
    """The control plane on the tenants' runtime: an undeclared 128-token
    root shared by four prompts is baked after three misses (on the pump
    thread) and reused by the fourth; then a 24-request open-loop Poisson
    replay at 4 qps over a static function and an adapter function."""
    from repro_torch.core import api as tidal
    from repro_torch.kernels import ops
    from repro_torch.runtime import ControlPlane, InvocationRequest
    vocab = model.cfg.vocab_size
    rt.deploy(tidal.static_function("cp-static", model, params), {},
              prewarm_seq=128)
    cp = ControlPlane(rt, min_hits=3, tick_interval_s=0)
    rng = np.random.default_rng(9)
    root = rng.integers(1, vocab, 128).astype(np.int32)
    prompts = [np.concatenate([root, rng.integers(1, vocab, 8 * int(rng.integers(
        2, 9)))]).astype(np.int32) for _ in range(4)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rt.gateway.start_pump()
    try:
        misses = [rt.submit(InvocationRequest("cp-static", p, max_new_tokens=16)
                            ).result(timeout=600) for p in prompts[:3]]
    finally:
        rt.gateway.stop_pump()
    cp.tick()
    hit = rt.submit("cp-static", {}, prompts[3], 16)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check_norm_launches(counts, model.cfg, "control plane")
    want_reuse = 128 - (128 - len(prompts[3])) % PAGE_SIZE
    pinned = cp.pinned_nbytes()
    if (cp.stats["prefix_bakes"] != 1 or not 0 < pinned <= cp.pinned_bytes_budget
            or hit.reused_prefix_len != want_reuse
            or any(m.reused_prefix_len for m in misses)):
        raise AssertionError(f"learned prefix: {cp.stats}, pinned {pinned}, "
                             f"reuse {hit.reused_prefix_len} != {want_reuse}")
    learned = {"bakes": cp.stats["prefix_bakes"], "pinned_bytes": pinned,
               "reused_prefix_len": hit.reused_prefix_len,
               "miss_ttft_ms": [m.ttft_s * 1e3 for m in misses],
               "hit_ttft_ms": hit.ttft_s * 1e3, "launches": counts}
    print(json.dumps({"learned_prefix": learned}))

    t, schedule = 0.0, []
    for i in range(24):
        t += rng.exponential(1 / 4.0)
        fn = "cp-static" if i % 2 == 0 else "fn-1"
        tail = rng.integers(1, vocab, int(rng.integers(16, 129))).astype(np.int32)
        prompt = np.concatenate([root, tail]) if i % 4 == 0 else tail
        schedule.append((t, InvocationRequest(fn, prompt, max_new_tokens=16)))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles = rt.gateway.replay(schedule)
    wall = time.perf_counter() - t0
    res = [h.result() for h in handles]
    counts = ops.launch_counts()
    check_norm_launches(counts, model.cfg, "open-loop replay")
    if any(r.status != "done" or len(r.tokens) != 16 for r in res):
        raise AssertionError("open-loop replay: unfinished invocations")
    ttft = np.asarray([r.ttft_s for r in res]) * 1e3
    kinds = {k: sum(r.kind == k for r in res) for k in ("cold", "fork", "warm")}
    replay = {"requests": len(res), "qps": 4.0, "wall_s": wall,
              "ttft_ms_p50": float(np.percentile(ttft, 50)),
              "ttft_ms_p95": float(np.percentile(ttft, 95)), "kinds": kinds,
              "reuse_hits": sum(r.reused_prefix_len > 0 for r in res),
              "control_plane": dict(cp.stats), "launches": counts}
    print(json.dumps({"open_loop": replay}))
    return {"learned_prefix": learned, "open_loop": replay}


# ---------------------------------------------------------------------------
# phase 8: the ssm family (ssd_scan, zamba2-2.7b)
# ---------------------------------------------------------------------------

def make_ssd_case(gen, B, S, bc_dtype, with_h0: bool, device) -> tuple:
    """Inputs as the zamba2 mixer makes them: xb [B, S, H, dh] fp32, B and
    C strided column slices of a [B, S, conv_ch] conv output, negative log
    decays, and an optional initial state."""
    c = ZAMBA2_SSD
    d_in, ds = c["d_inner"], c["ds"]
    conv = (torch.randn((B, S, d_in + 2 * ds), generator=gen) * 0.5).to(
        device, bc_dtype)
    xb = torch.randn((B, S, c["H"], c["dh"]), generator=gen).to(device)
    ld = (-torch.rand((B, S, c["H"]), generator=gen) * 0.25).to(device)
    h0 = (torch.randn((B, c["H"], c["dh"], ds), generator=gen).to(device)
          if with_h0 else None)
    return xb, conv[..., d_in:d_in + ds], conv[..., d_in + ds:], ld, h0


def phase_ssm_kernels(device) -> list:
    """``ssd_scan`` against both plain versions, and the attention kernels
    at zamba2's head dim of 80, on the card, timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator().manual_seed(8)
    rng = np.random.default_rng(8)
    c = ZAMBA2_SSD
    Q = c["Q"]
    results = []
    # S = 64 and 384 are the ends of zamba2's serving prompts
    for B, S, with_h0 in ((1, 128, False), (1, 512, False), (1, 200, False),
                          (4, 256, True), (1, 64, False), (1, 384, False)):
        for bc_dtype in (torch.bfloat16, torch.float32):
            args = make_ssd_case(gen, B, S, bc_dtype, with_h0, device)
            y, h = ssd_scan(*args[:4], Q, args[4])
            y2, h2 = ssd_scan(*args[:4], Q, args[4])
            plain = {"sequential": ref.ssd_scan_ref(*args)}
            if S % Q == 0:
                plain["chunked"] = ref.ssd_chunked_ref(*args[:4], Q, args[4])
            torch.cuda.synchronize()
            errs, ok = {}, True
            for name, (yp, hp) in plain.items():
                ey = float((y - yp).abs().max())
                eh = float((h - hp).abs().max())
                ty, th = 1e-4 * float(yp.abs().max()), 1e-4 * float(hp.abs().max())
                errs[name] = {"y": ey, "h": eh, "tol_y": ty, "tol_h": th}
                ok = ok and ey <= ty and eh <= th
            same = torch.equal(y, y2) and torch.equal(h, h2)
            kern_ms = time_ms(lambda: ssd_scan(*args[:4], Q, args[4]))
            plain_ms = time_ms(lambda: ref.ssd_ref(*args[:4], Q, args[4]),
                               reps=3, graph_calls=1)
            flops, nbytes = ssd_work(B, S, c["H"], c["dh"], c["ds"], Q,
                                     bc_dtype, with_h0)
            b_ms, b_by = bound_ms(flops, nbytes, "tf32")
            res = {"kernel": "ssd_scan", "shape": "zamba2-2.7b", "B": B, "S": S,
                   "H": c["H"], "dh": c["dh"], "ds": c["ds"], "Q": Q,
                   "h0": with_h0, "bc_dtype": str(bc_dtype)[6:],
                   "max_abs_err": max(max(e["y"], e["h"]) for e in errs.values()),
                   "errors": errs, "tol": "1e-4 of the largest |y| and |h|",
                   "deterministic": same, "ms": kern_ms, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            results.append(res)
            print(json.dumps(res))
            if not ok or not same:
                raise AssertionError(f"ssd_scan disagrees: {res}")
            if B > 1:
                results.append(ssd_invariance(args, Q, y, h, bc_dtype))

    H, KV, d = ZAMBA2_ATTN["H"], ZAMBA2_ATTN["KV"], ZAMBA2_ATTN["d"]
    for dtype in (torch.bfloat16, torch.float32):
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        S = T = 384
        q = torch.randn((1, H, S, d), generator=gen).to(device, dtype)
        k = torch.randn((1, KV, T, d), generator=gen).to(device, dtype)
        v = torch.randn((1, KV, T, d), generator=gen).to(device, dtype)
        out = flash_attention(q, k, v)
        err = float((out.float() - ref.flash_attention_ref(q, k, v).float()
                     ).abs().max())
        flops, nbytes = flash_work(1, H, KV, S, T, d, dtype)
        b_ms, b_by = bound_ms(flops, nbytes, dtype)
        res = {"kernel": "flash_attention", "shape": "zamba2-2.7b", "B": 1,
               "H": H, "KV": KV, "d": d, "S": S, "T": T, "dtype": str(dtype)[6:],
               "softcap": 0.0, "max_abs_err": err, "tol": tol,
               "ms": time_ms(lambda: flash_attention(q, k, v)),
               "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v)),
               "library_ms": time_ms(lambda: sdpa_gqa(q, k, v, is_causal=True)),
               "bound_ms": b_ms, "bound_by": b_by}
        results.append(res)
        print(json.dumps(res))
        if not err <= tol:
            raise AssertionError(f"flash_attention disagrees at d = 80: {res}")

        B, T = 8, 512
        lengths = [1] + rng.integers(2, T + 1, B - 2).tolist() + [T]
        q = torch.randn((B, H, d), generator=gen).to(device, dtype)
        ck = torch.randn((B, T, KV, d), generator=gen).to(device, dtype)
        cv = torch.randn((B, T, KV, d), generator=gen).to(device, dtype)
        ln = torch.as_tensor(lengths, dtype=torch.int32, device=device)
        k, v = ck.transpose(1, 2), cv.transpose(1, 2)
        out = decode_attention(q, k, v, ln)
        err = float((out.float() - ref.decode_attention_ref(q, k, v, ln).float()
                     ).abs().max())
        mask = (torch.arange(T, device=device)[None, :]
                < ln[:, None].long())[:, None, None, :]
        flops, nbytes = decode_work(B, H, KV, d, lengths, dtype)
        b_ms, b_by = bound_ms(flops, nbytes, dtype)
        res = {"kernel": "decode_attention", "shape": "zamba2-2.7b", "B": B,
               "H": H, "KV": KV, "d": d, "T": T, "max_len": int(max(lengths)),
               "dtype": str(dtype)[6:], "max_abs_err": err, "tol": tol,
               "ms": time_ms(lambda: decode_attention(q, k, v, ln)),
               "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, ln)),
               "library_ms": time_ms(lambda: sdpa_gqa(q[:, :, None], k, v,
                                                      attn_mask=mask)),
               "bound_ms": b_ms, "bound_by": b_by}
        results.append(res)
        print(json.dumps(res))
        if not err <= tol:
            raise AssertionError(f"decode_attention disagrees at d = 80: {res}")
    results.append(attention_invariance(device, gen, ZAMBA2_ATTN, "zamba2-2.7b"))
    return results


def ssd_invariance(args: tuple, Q: int, y, h, bc_dtype) -> dict:
    """Bitwise checks of ``ssd_scan`` that the layer-streamed prefill and
    batched prefills rely on: each sequence of a batch run alone gives the
    bits it got in the batch, and a repeated call gives the first call's;
    B and C on unaligned rows (element loads in place of cp.async) give
    the same bits too."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    xb, Bm, Cm, ld, h0 = args
    alone = []
    for b in range(xb.shape[0]):
        s = slice(b, b + 1)
        ya, ha = ssd_scan(xb[s], Bm[s], Cm[s], ld[s], Q, None if h0 is None else h0[s])
        alone.append(torch.equal(ya, y[s]) and torch.equal(ha, h[s]))
    yr, hr = ssd_scan(xb, Bm, Cm, ld, Q, h0)
    yu, hu = ssd_scan(xb, unaligned_copy(Bm), unaligned_copy(Cm), ld, Q, h0)
    row = {"invariance": "ssd_scan zamba2-2.7b", "B": int(xb.shape[0]),
           "S": int(xb.shape[1]), "bc_dtype": str(bc_dtype)[6:],
           "ssd_alone_equals_batch": all(alone),
           "ssd_repeat_equal": torch.equal(yr, y) and torch.equal(hr, h),
           "ssd_unaligned_bc_equal": torch.equal(yu, y) and torch.equal(hu, h)}
    print(json.dumps(row))
    if not all(v for k, v in row.items() if k.startswith("ssd_")):
        raise AssertionError(f"ssd_scan invariance broken: {row}")
    return row


def zamba_model(device, seed: int = 0):
    """zamba2-2.7b at full width and depth with seeded random weights."""
    from repro_torch.models.registry import get_model
    model = get_model("zamba2-2.7b", device=device)
    cfg = model.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.attn_every) == (54, 2560, 6)
    t0 = time.perf_counter()
    params = model.init_params(seed=seed)
    torch.cuda.synchronize()
    print(f"zamba2-2.7b: {cfg.n_layers} Mamba2 layers + 1 shared attention "
          f"block x {attention_launches(cfg)}, d_model {cfg.d_model}, "
          f"{model.dtype}, weights (seed {seed}) in "
          f"{time.perf_counter() - t0:.1f} s")
    return model, params


def check_zamba_launches(counts: dict, cfg, prefills: int, steps: int,
                         where: str) -> None:
    """Exact launches of ``prefills`` prefill calls (S > 1) and ``steps``
    decode steps of a zamba model."""
    units = attention_launches(cfg)
    want = {"ssd_scan": cfg.n_layers * prefills,
            "flash_attention": units * prefills,
            "decode_attention": units * steps,
            "rmsnorm": norm_launches(cfg) * (prefills + steps),
            "rmsnorm_fused": fused_norm_launches(cfg) * (prefills + steps),
            "paged_decode_attention": 0, **NO_BACKWARD}
    if counts != want:
        raise AssertionError(f"{where}: launches {counts} != {want} "
                             f"({prefills} prefills, {steps} decode steps)")


def check_xlstm_launches(counts: dict, cfg, calls: int, where: str) -> None:
    """Exact launches of ``calls`` model calls of an xlstm model: rmsnorm
    only (103 per call for xlstm-1.3b, 6 of them fused), no attention
    kernel and no ``ssd_scan``."""
    want = {"rmsnorm": norm_launches(cfg) * calls,
            "rmsnorm_fused": fused_norm_launches(cfg) * calls,
            "ssd_scan": 0, "flash_attention": 0, "decode_attention": 0,
            "paged_decode_attention": 0, **NO_BACKWARD}
    if counts != want:
        raise AssertionError(f"{where}: launches {counts} != {want} "
                             f"({calls} model calls)")


def dense_continuous(model, params, prompts: list, new_tokens: int,
                     where: str, max_len: int = 512) -> tuple:
    """Every prompt through one dense-pool ContinuousBatchingEngine (8
    slots), launch counts checked (zamba or xlstm); returns (row,
    tokens)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, params, n_slots=8, max_len=max_len)
    if eng.paged:
        raise AssertionError(f"{model.cfg.name} must serve over the dense "
                             "slot pool")
    host = []
    decode_step = model.decode_step

    def timed_decode(*a, **kw):             # host time of one decode call
        t = time.perf_counter()
        out = decode_step(*a, **kw)
        host.append(time.perf_counter() - t)
        return out

    model.decode_step = timed_decode
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        ids = [eng.submit(p, new_tokens) for p in prompts]
        results = eng.run()
    finally:
        del model.decode_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    res = [results[i] for i in ids]
    vocab = model.cfg.vocab_size
    if any(r.status != "done" or r.n_generated != new_tokens
           or not ((r.tokens >= 0) & (r.tokens < vocab)).all() for r in res):
        raise AssertionError(f"{where}: unfinished requests")
    if model.cfg.family == "xlstm":
        check_xlstm_launches(counts, model.cfg,
                             eng.n_prefill_calls + eng.n_decode_steps, where)
    else:
        check_zamba_launches(counts, model.cfg, eng.n_prefill_calls,
                             eng.n_decode_steps, where)
    ttft = np.asarray([r.ttft_s for r in res]) * 1e3
    row = {"pass": where, "requests": len(res),
           "state_bytes_per_slot": eng.pool.nbytes() // eng.pool.n_slots,
           "prompt_lens": [int(r.prompt_len) for r in res],
           "new_tokens": new_tokens, "decode_steps": eng.n_decode_steps,
           "prefill_calls": eng.n_prefill_calls, "launches": counts,
           "wall_s": wall, "tokens_per_s": new_tokens * len(res) / wall,
           "decode_host_ms_median": float(np.median(host) * 1e3),
           "decode_host_ms_max": float(np.max(host) * 1e3),
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_max": float(ttft.max())}
    print(json.dumps(row))
    return row, [r.tokens for r in res]


def phase_zamba(device, h2d: float) -> dict:
    """zamba2-2.7b at full width: the dense-pool continuous engine, the
    sequential Engine, a 2-layer fp32 parity check, streamed prefill and
    FaaSRuntime cold / fork / warm."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import Engine
    model, params = zamba_model(device)
    cfg, vocab = model.cfg, model.cfg.vocab_size
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in ZAMBA_LENGTHS]
    dense_continuous(model, params, prompts[:2], 2, "zamba warm-up")
    serve, _ = dense_continuous(model, params, prompts, 16, "zamba dense pool")

    batch = np.random.default_rng(11).integers(1, vocab, (8, 256)).astype(np.int32)
    eng = Engine(model, params)
    eng.generate(batch[:, :32], max_new_tokens=2)             # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate(batch, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_zamba_launches(counts, cfg, 1, 31, "zamba Engine")
    cont, cont_tokens = dense_continuous(model, params, list(batch), 32,
                                         "zamba dense pool, Engine's prompts")
    equal = sum(int((res.tokens[i] == t).sum()) for i, t in enumerate(cont_tokens))
    engine = {"pass": "zamba engine", "batch": 8, "prompt_len": 256,
              "new_tokens": 32, "launches": counts, "wall_s": wall,
              "ttft_ms": res.ttft_s * 1e3,
              "decode_ms_per_step": res.decode_s / 31 * 1e3,
              "tokens_per_s": 8 * 32 / wall,
              "tokens_equal_to_continuous": f"{equal}/{8 * 32}"}
    print(json.dumps(engine))
    if equal != 8 * 32:
        raise AssertionError(f"Engine tokens differ from the continuous "
                             f"engine's: {equal}/{8 * 32}")
    out = {"serve": serve, "engine": engine, "engine_prompts_continuous": cont}
    out["faas"] = zamba_faas(model, params, prompts, h2d)
    del model, params
    torch.cuda.empty_cache()
    out["parity"] = zamba_parity(device)
    return out


def zamba_parity(device) -> dict:
    """A 2-layer fp32 zamba2 at full width (one unit of two Mamba2 blocks
    and the shared block): ``recurrent_parity`` on a ragged 200-token
    prompt pair, logits within 1e-3."""
    from repro_torch.models.registry import get_config
    cfg = get_config("zamba2-2.7b").replace(n_layers=2, attn_every=2,
                                            dtype="float32")
    prompts = np.random.default_rng(12).integers(1, cfg.vocab_size, (2, 200)
                                                 ).astype(np.int32)
    return recurrent_parity(cfg, device, prompts, lambda _: 1e-3, "zamba", 64)


def recurrent_parity(cfg, device, prompts: np.ndarray, tol, tag: str,
                     trace_seq: int) -> dict:
    """``cfg`` (fp32, cut depth, full width): the same seeded weights on
    the card (kernels) and on the CPU (plain versions), ``prompts`` and 8
    greedy decode steps through the ``Engine``, logits within
    ``tol(largest |logit|)`` and tokens equal; then the card's
    layer-streamed prefill of a forked session against its monolithic
    prefill, bit for bit."""
    from repro_torch.core import api as tidal
    from repro_torch.core.streaming import streamed_prefill
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.models.registry import get_model
    from repro_torch.runtime import Engine
    from repro_torch.utils import named_leaves
    runs = {}
    for dev in (device, "cpu"):
        model = get_model(cfg, device=dev)
        logits = []

        def prefill(p, inputs, cache, m=model, out=logits):
            lg, cache = m.prefill(p, inputs, cache)
            out.append(lg.float().cpu())
            return lg, cache

        def decode(p, cache, inputs, pos, m=model, out=logits):
            lg, cache = m.decode_step(p, cache, inputs, pos)
            out.append(lg.float().cpu())
            return lg, cache

        res = Engine(model, model.init_params(seed=1), prefill, decode
                     ).generate(prompts, max_new_tokens=9)
        runs[str(dev)] = (torch.stack(logits), res.tokens)
    (lg_gpu, tk_gpu), (lg_cpu, tk_cpu) = runs[str(device)], runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    out = {"config": f"{cfg.name} x {cfg.n_layers} layers, {cfg.dtype}",
           "max_abs_logit_err": err, "max_abs_logit": float(lg_cpu.abs().max()),
           "tol": tol(float(lg_cpu.abs().max())),
           "tokens_equal": bool((tk_gpu == tk_cpu).all()),
           "tokens_card": tk_gpu.tolist()}
    if not err <= out["tol"] or not out["tokens_equal"]:
        raise AssertionError(f"{tag} card vs CPU parity failed: {out}")

    model = get_model(cfg, device=device)
    params = model.init_params(seed=1)
    srv = TemplateServer(trace_seq=trace_seq)
    srv.register(tidal.static_function("z", model, params), {})
    session, _ = srv.fork("z", {})
    lg_s, c_s = streamed_prefill(session, {"tokens": prompts[:1]},
                                 model.make_cache(1, 256))
    lg_m, c_m = model.prefill(params, {"tokens": prompts[:1]},
                              model.make_cache(1, 256))
    torch.cuda.synchronize()
    out["streamed_prefill_equal"] = bool(torch.equal(lg_s, lg_m) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(c_s),
                                                    named_leaves(c_m))))
    print(json.dumps({f"{tag}_parity": out}))
    if not out["streamed_prefill_equal"]:
        raise AssertionError(f"{tag} streamed prefill differs from prefill")
    return out


def zamba_faas(model, params, prompts: list, h2d: float) -> dict:
    """A static zamba2-2.7b function through ``FaaSRuntime`` and the pump
    thread: cold, warm, then fork and warm after an evict; then one fork
    alone and one warm invocation alone."""
    from repro_torch.core import api as tidal
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.runtime import FaaSRuntime, InvocationRequest
    rt = FaaSRuntime(server=TemplateServer(hw=H100_SXM.with_h2d(h2d),
                                           trace_seq=128),
                     n_slots=8, max_len=512, device=model.device)
    t0 = time.perf_counter()
    rt.deploy(tidal.static_function("zamba", model, params), {},
              prewarm_seq=128)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    tpl = rt.server.templates["zamba"]
    results = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rt.gateway.start_pump()
    try:
        for wave in ([0, 1], "evict", [2, 3]):
            if wave == "evict":
                rt.evict()
                continue
            handles = [rt.submit(InvocationRequest("zamba", prompts[i],
                                                   max_new_tokens=16))
                       for i in wave]
            results += [h.result(timeout=600) for h in handles]
    finally:
        rt.gateway.stop_pump()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    kinds = [r.kind for r in results]
    if kinds != ["cold", "warm", "fork", "warm"]:
        raise AssertionError(f"zamba service kinds {kinds}")
    if any(r.status != "done" or len(r.tokens) != 16 for r in results):
        raise AssertionError("unfinished zamba invocations")
    forks = [r for r in results if r.fork_stats is not None]
    for r in forks:
        fs = r.fork_stats
        if not r.streamed_prefill or (fs.reused_bytes + fs.streamed_bytes
                                      + fs.dynamic_bytes != tpl.total_bytes):
            raise AssertionError(f"zamba fork: streamed {r.streamed_prefill}, "
                                 f"bytes {fs} != {tpl.total_bytes}")
    check_norm_launches(counts, model.cfg, "zamba FaaS")
    if counts["ssd_scan"] * attention_launches(model.cfg) != (
            model.cfg.n_layers * counts["flash_attention"]) or counts[
                "paged_decode_attention"]:
        raise AssertionError(f"zamba FaaS launches {counts}")
    rt.evict()
    fork = rt.submit("zamba", {}, prompts[4], 16)
    warm = rt.submit("zamba", {}, prompts[4], 16)
    if (fork.kind, warm.kind) != ("fork", "warm") or not np.array_equal(
            fork.tokens, warm.tokens):
        raise AssertionError(f"zamba isolated pair: {fork.kind} {warm.kind}")
    out = {"deploy_s": deploy_s, "model_bytes": tpl.total_bytes,
           "kinds": kinds, "launches": counts,
           "ttft_ms": {r.kind + str(i): r.ttft_s * 1e3
                       for i, r in enumerate(results)},
           "fork_bytes": [{"reused": r.fork_stats.reused_bytes,
                           "streamed": r.fork_stats.streamed_bytes,
                           "dynamic": r.fork_stats.dynamic_bytes}
                          for r in forks],
           "resident_bytes_after_eq1": tpl.resident_bytes,
           "isolated": {"fork_ttft_ms": fork.ttft_s * 1e3,
                        "warm_ttft_ms": warm.ttft_s * 1e3,
                        "fork_s_ms": fork.fork_stats.fork_s * 1e3,
                        "streamed_bytes": fork.fork_stats.streamed_bytes,
                        "reused_bytes": fork.fork_stats.reused_bytes,
                        "prompt_len": len(prompts[4])}}
    print(json.dumps({"zamba_faas": out}))
    rt.evict()
    return out


# ---------------------------------------------------------------------------
# phases 9 and 10: llama2-13b at full depth, phi3.5-moe at cut depth
# ---------------------------------------------------------------------------

# phi3.5-moe-42b-a6.6b does not fit one card at its 32 layers (84 GB);
# phase 10 takes the largest depth whose FaaS runtime fits (see
# ``fitting_depth``), keeping these margins free: on the card for the
# arena, activations and the caching allocator's slack (1.5 GB at 8
# layers), on the host for the transient leaves of the random draw and
# the serving passes
DEVICE_SLACK_BYTES = 6e9
HOST_SLACK_BYTES = 10e9
# phase 10's depth at most (its draw and serving passes grow with it; the
# whole script keeps to its time limit with phase 11 after it)
MOE_MAX_LAYERS = 8
# phase 11's fp32 card against CPU check: one full-width layer holds 256
# experts of 46 GB in fp32 on each side, too much for the host
DEEPSEEK_PARITY_EXPERTS = 32


def meminfo() -> dict:
    """The host's total and available memory in GB (``/proc/meminfo``)."""
    kb = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key in ("MemTotal", "MemAvailable"):
                kb[key] = int(rest.split()[0])
    return {"host_total_gb": kb.get("MemTotal", 0) * 1024 / 1e9,
            "host_available_gb": kb.get("MemAvailable", 0) * 1024 / 1e9}


def release_host_memory() -> None:
    """Collect unreferenced objects, then return the pinned blocks that
    PyTorch's host allocator keeps cached for reuse to the system (a freed
    pinned tensor stays in that cache, rounded up to a power of two)."""
    gc.collect()
    torch._C._host_emptyCache()


def host_free_bytes() -> int:
    """Host memory this process may still take: ``MemAvailable``, or less
    where its cgroup's limit leaves less."""
    free = meminfo()["host_available_gb"] * 1e9
    cg = Path("/sys/fs/cgroup")
    try:
        limit = (cg / "memory.max").read_text().strip()
        if limit != "max":
            free = min(free, int(limit) - int((cg / "memory.current").read_text()))
    except (OSError, ValueError):
        pass
    return int(free)


def fitting_depth(cfg, device, cap: int | None = None) -> dict:
    """The largest depth of ``cfg`` (at most its own, and at most ``cap``)
    at which ``big_faas`` fits: on the card a warm copy of the weights, a
    fork's copy and ``DEVICE_SLACK_BYTES`` within the free memory; on the
    host the function's checkpoint and its pinned pool (the weights'
    exact bytes, laid out at ``HOST_ALIGN``), or earlier the random
    draw's peak (the largest leaf in float32 and its cast), plus
    ``HOST_SLACK_BYTES`` within ``host_free_bytes()``.  Read with nothing
    of the model allocated; returns the depth, the budget that stopped it
    and the bytes it was worked out from."""
    from repro_torch.core.merging import host_layout
    from repro_torch.models.transformer import param_specs, torch_dtype
    from repro_torch.utils import named_leaves

    def sizes(n):
        leaves = [(p, t.numel() * t.element_size()) for p, t in
                  named_leaves(param_specs(cfg.replace(n_layers=n)))]
        return sum(b for _, b in leaves), host_layout(leaves)[1]

    (dev1, pin1), (dev2, pin2) = sizes(1), sizes(2)
    layer_dev, layer_pin = dev2 - dev1, pin2 - pin1
    base_dev, base_pin = dev1 - layer_dev, pin1 - layer_pin
    largest = max(t.numel() for _, t in named_leaves(param_specs(
        cfg.replace(n_layers=1))))
    draw_peak = largest * (4 + torch.empty((), dtype=torch_dtype(cfg.dtype))
                           .element_size())
    device_free = torch.cuda.mem_get_info(device)[0]
    host_free = host_free_bytes()
    by_device = int((device_free - DEVICE_SLACK_BYTES - 2 * base_dev)
                    // (2 * layer_dev))
    by_host = int((host_free - HOST_SLACK_BYTES - base_dev - base_pin)
                  // (layer_dev + layer_pin))
    if host_free - HOST_SLACK_BYTES < draw_peak:
        by_host = 0
    depth = min(cfg.n_layers, by_device, by_host, cap or cfg.n_layers)
    out = {"depth": depth, "cap": cap, "draw_peak_bytes": draw_peak,
           "limited_by": ("full depth" if depth == cfg.n_layers else
                          "the script's time limit" if depth == cap and cap < min(
                              by_device, by_host) else
                          "the device's memory" if by_device <= by_host
                          else "the host's memory"),
           "by_device": by_device, "by_host": by_host,
           "device_free_bytes": device_free, "host_free_bytes": host_free,
           "layer_bytes": layer_dev, "layer_pinned_bytes": layer_pin,
           "base_bytes": base_dev, "base_pinned_bytes": base_pin,
           "device_slack_bytes": DEVICE_SLACK_BYTES,
           "host_slack_bytes": HOST_SLACK_BYTES}
    print(json.dumps({"fitting_depth": out}))
    if depth < 1:
        raise AssertionError(f"{cfg.name}: not one layer fits: {out}")
    return out


def pinned_bytes(server) -> dict:
    """Page-locked host bytes: the pinned host allocator's held (cached
    blocks included) and handed out, by its own statistics, the bytes the
    template ``server``'s pools registered in place (``cudaHostRegister``,
    which those statistics do not see), and the sum of held and
    registered."""
    stats = torch.cuda.host_memory_stats()
    held = stats.get("allocated_bytes.current") or 0
    return {"pinned_held_bytes": held,
            "pinned_active_bytes": stats.get("active_bytes.current"),
            "registered_bytes": server.registered_bytes(),
            "pinned_bytes": held + server.registered_bytes()}


def big_model(arch: str, device, seed: int = 0, **replace) -> tuple:
    """``arch`` at full width (depth cut by ``replace``) with seeded random
    weights, drawn on the CPU leaf by leaf and moved to the card."""
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.utils import tree_bytes
    model = get_model(get_config(arch).replace(**replace), device=device)
    t0 = time.perf_counter()
    params = model.init_params(seed=seed)
    torch.cuda.synchronize()
    info = {"arch": arch, "layers": model.cfg.n_layers,
            "d_model": model.cfg.d_model, "dtype": model.cfg.dtype,
            "init_s": time.perf_counter() - t0, "param_bytes": tree_bytes(params),
            **meminfo()}
    print(json.dumps({"model": info}))
    return model, params, info


def moe_drops(calls) -> dict:
    """The (token, k) pairs of the expert layer calls recorded by
    ``moe.watch()`` and those their capacity dropped, split by prefill
    (S > 1) and decode calls.  Reads back through host syncs, so passes
    watched are not timed."""
    out = {"prefill_dropped": 0, "prefill_pairs": 0, "decode_dropped": 0,
           "decode_pairs": 0}
    for S, _, keep in calls:
        kind = "decode" if S == 1 else "prefill"
        out[kind + "_dropped"] += int((~keep).sum())
        out[kind + "_pairs"] += keep.numel()
    return out


def card_cpu_parity(cfg, device, seed: int = 1, n_slots: int = 2,
                    chunk: int | None = None, cpu_params=None) -> dict:
    """``cfg`` (fp32, cut depth, full width): the same CPU-drawn weights on
    the card (kernels) and on the CPU (plain versions), through a paged
    pool of ``n_slots`` slots: a 100-token prefill (in ``chunk``-token
    pieces, the later ones through ``prefill_from``, when given) and 8
    greedy paged decode steps of one busy slot, logits within 1e-4 of the
    largest |logit| and tokens equal (moe: every call's expert ids and kept pairs equal; the free
    slots' rows take capacity too, so 8 slots at cf 1.25 drop pairs at
    decode); then the card's layer-streamed prefill of a forked session
    equals its monolithic prefill bit for bit.  ``cpu_params``: weights
    already drawn for ``cfg`` on the CPU (else drawn from ``seed``)."""
    from repro_torch.core import api as tidal
    from repro_torch.core.streaming import streamed_prefill
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.models import moe
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import to_device
    from repro_torch.runtime import PagedKVCachePool
    from repro_torch.utils import named_leaves
    cpu_model = get_model(cfg, device="cpu")
    if cpu_params is None:
        cpu_params = cpu_model.init_params(seed=seed)
    card_model = get_model(cfg, device=device)
    card_params = to_device(cpu_params, card_model.device)
    prompt = np.random.default_rng(2).integers(1, cfg.vocab_size, 100).astype(np.int32)
    step = chunk or len(prompt)
    runs = {}
    for model, params in ((card_model, card_params), (cpu_model, cpu_params)):
        with moe.watch() as calls:
            pool = PagedKVCachePool(model, n_slots=n_slots, max_len=128,
                                    page_size=PAGE_SIZE)
            cache = model.make_cache(1, pool.padded_len)
            for start in range(0, len(prompt), step):
                piece = {"tokens": prompt[None, start:start + step]}
                if start:
                    logits, cache = model.prefill_from(params, piece, cache, start)
                else:
                    logits, cache = model.prefill(params, piece, cache)
            slot = pool.alloc(len(prompt), 8)
            pool.write_prompt(slot, cache, len(prompt))
            all_logits, toks = [logits[0].float().cpu()], [int(logits[0].argmax())]
            pos = np.zeros(n_slots, np.int32)
            pos[slot] = len(prompt)
            for _ in range(8):
                pool.ensure_len(slot, int(pos[slot]) + 1)
                tok = np.zeros((n_slots, 1), np.int32)
                tok[slot, 0] = toks[-1]
                lg, _ = model.decode_step_paged(params, pool.cache, {"tokens": tok},
                                                pos, pool.device_page_table(),
                                                PAGE_SIZE)
                all_logits.append(lg[slot].float().cpu())
                toks.append(int(lg[slot].argmax()))
                pos[slot] += 1
        routes = [(S, idx.cpu(), keep.cpu()) for S, idx, keep in calls]
        runs[model.device.type] = (torch.stack(all_logits), toks, routes)
    (lg_gpu, tk_gpu, rt_gpu), (lg_cpu, tk_cpu, rt_cpu) = runs["cuda"], runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    tol = 1e-4 * float(lg_cpu.abs().max())
    res = {"config": f"{cfg.name} x {cfg.n_layers} layers, {cfg.dtype}",
           "n_slots": n_slots, "prefill_chunk": chunk,
           "max_abs_logit_err": err, "max_abs_logit": float(lg_cpu.abs().max()),
           "tol": tol, "tokens_equal": tk_gpu == tk_cpu,
           "moe_calls": len(rt_gpu),
           "routing_equal": len(rt_gpu) == len(rt_cpu) and all(
               s1 == s2 and torch.equal(i1, i2) and torch.equal(k1, k2)
               for (s1, i1, k1), (s2, i2, k2) in zip(rt_gpu, rt_cpu)),
           "drops_card": moe_drops(rt_gpu), "drops_cpu": moe_drops(rt_cpu)}
    del cpu_params, cpu_model
    srv = TemplateServer(trace_seq=64)
    srv.register(tidal.static_function("f", card_model, card_params), {})
    session, _ = srv.fork("f", {})
    toks = prompt[None]
    lg_s, c_s = streamed_prefill(session, {"tokens": toks}, card_model.make_cache(1, 128))
    lg_m, c_m = card_model.prefill(card_params, {"tokens": toks},
                                   card_model.make_cache(1, 128))
    torch.cuda.synchronize()
    res["streamed_prefill_equal"] = bool(torch.equal(lg_s, lg_m) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(c_s),
                                                    named_leaves(c_m))))
    print(json.dumps({"card_cpu_parity": res}))
    if not (err <= tol and res["tokens_equal"] and res["routing_equal"]
            and res["drops_card"] == res["drops_cpu"]
            and res["streamed_prefill_equal"]):
        raise AssertionError(f"card vs CPU parity failed: {res}")
    return res


def chunked_prefill_witness(model, params, prompt: np.ndarray,
                            chunk: int) -> dict:
    """A moe ``model`` whose capacity drops nothing: ``prompt`` prefilled
    whole and in ``chunk``-token pieces (``prefill_from``, as the engine's
    chunked prefill runs them).  Returns the last-token logits' largest
    difference, how many (token, layer) expert choices differ, and the
    pairs dropped (none: chunking then changes only the rounding)."""
    from repro_torch.models import moe
    L, runs = model.cfg.n_layers, []
    for step in (len(prompt), chunk):
        cache = model.make_cache(1, 512)
        with moe.watch() as calls:
            for start in range(0, len(prompt), step):
                piece = {"tokens": prompt[None, start:start + step]}
                if start:
                    logits, cache = model.prefill_from(params, piece, cache, start)
                else:
                    logits, cache = model.prefill(params, piece, cache)
        # calls run layer by layer within each piece
        routes = [torch.cat([calls[i][1] for i in range(layer, len(calls), L)])
                  for layer in range(L)]
        runs.append((logits[0].float(), routes, moe_drops(calls)))
    (lg_a, rt_a, dr_a), (lg_b, rt_b, dr_b) = runs
    out = {"config": f"{model.cfg.name} x {L} layers, {model.cfg.dtype}, cf "
                     f"{model.cfg.capacity_factor}",
           "prompt_len": len(prompt), "chunk": chunk,
           "max_abs_logit_diff": float((lg_a - lg_b).abs().max()),
           "max_abs_logit": float(lg_a.abs().max()),
           "routes_differ": sum(int((a != b).any(-1).sum())
                                for a, b in zip(rt_a, rt_b)),
           "routes": L * len(prompt),
           "pairs_dropped": dr_a["prefill_dropped"] + dr_b["prefill_dropped"]}
    print(json.dumps({"chunked_prefill_witness": out}))
    if out["pairs_dropped"]:
        raise AssertionError(f"the dropless witness dropped pairs: {out}")
    return out


def engine_vs_continuous(model, params, prompts: np.ndarray, new_tokens: int,
                         n_slots: int, per_prompt: bool) -> dict:
    """The sequential ``Engine`` (dense cache: flash prefill, then
    ``decode_attention``) against the paged continuous engine with
    ``n_slots`` slots over the same prompts: greedy tokens equal, launch
    counts exact.  ``per_prompt`` runs the Engine on one prompt at a time
    (a moe prefill then routes the same T tokens as the continuous
    engine's), else on the whole batch at once.  An MLA decode attends over
    every row of its cache, so the Engine's dense cache takes the paged
    pool's padded length (512): the same reduction, the same bits."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import ContinuousBatchingEngine, Engine
    cfg, L = model.cfg, attention_kernels(model.cfg)
    n_norm, n_fused = norm_launches(cfg), fused_norm_launches(cfg)
    cache_len = 512 if cfg.use_mla else None
    eng = Engine(model, params)
    eng.generate(prompts[:1, :32], max_new_tokens=2)           # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if per_prompt:
        runs = [eng.generate(p[None], max_new_tokens=new_tokens,
                             cache_len=cache_len) for p in prompts]
        want = np.concatenate([r.tokens for r in runs])
        calls = len(prompts)
    else:
        runs = [eng.generate(prompts, max_new_tokens=new_tokens,
                             cache_len=cache_len)]
        want, calls = runs[0].tokens, 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    expect = {"decode_attention": L * (new_tokens - 1) * calls,
              "flash_attention": L * calls,
              "rmsnorm": n_norm * new_tokens * calls,
              "rmsnorm_fused": n_fused * new_tokens * calls,
              "paged_decode_attention": 0, "ssd_scan": 0, **NO_BACKWARD}
    if counts != expect:
        raise AssertionError(f"{cfg.name} Engine launches {counts} != {expect}")
    row = {"pass": "engine", "arch": cfg.name, "batch": len(prompts),
           "per_prompt": per_prompt, "prompt_len": int(prompts.shape[1]),
           "new_tokens": new_tokens, "launches": counts, "wall_s": wall,
           "ttft_ms": float(np.mean([r.ttft_s for r in runs]) * 1e3),
           "decode_ms_per_step": float(np.mean([r.decode_s for r in runs])
                                       / (new_tokens - 1) * 1e3)}
    cbe = ContinuousBatchingEngine(model, params, n_slots=n_slots, max_len=512,
                                   page_size=PAGE_SIZE)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ids = [cbe.submit(p, new_tokens) for p in prompts]
    results = cbe.run()
    torch.cuda.synchronize()
    cont_wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    got = np.stack([results[i].tokens for i in ids])
    calls = cbe.n_decode_steps + cbe.n_prefill_calls
    expect = {"decode_attention": 0, "flash_attention": L * cbe.n_prefill_calls,
              "paged_decode_attention": L * cbe.n_decode_steps,
              "rmsnorm": n_norm * calls, "rmsnorm_fused": n_fused * calls,
              "ssd_scan": 0, **NO_BACKWARD}
    if counts != expect:
        raise AssertionError(f"{cfg.name} continuous launches {counts} != {expect}")
    equal = int((got == want).sum())
    row.update(continuous={"pass": "engine prompts, continuous", "arch": cfg.name,
                           "n_slots": n_slots, "launches": counts,
                           "wall_s": cont_wall,
                           "decode_steps": cbe.n_decode_steps,
                           "prefill_calls": cbe.n_prefill_calls},
               tokens_equal=f"{equal}/{want.size}")
    cbe.close()
    print(json.dumps(row))
    if equal != want.size:
        raise AssertionError(f"{cfg.name}: Engine tokens differ from the "
                             f"continuous engine's: {equal}/{want.size}")
    return row


def profiled_steps(calls: list) -> dict:
    """Run ``calls`` in order under ``torch.profiler``: their wall ms per
    call, the device ms per call and its share of the wall, and the
    kernels that took the most device time (ms and calls per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = len(calls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # device-side events only: a CPU op reports the device time of the
    # kernels it launched as its own, so summing both counts it twice
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(((e.key, device_us(e) / 1e3 / n, e.count // n)
                  for e in events if device_us(e) > 0), key=lambda r: -r[1])
    return {"profiled_ms_per_step": wall / n * 1e3,
            "device_ms_per_step": device_ms / n if device_ms else None,
            "device_busy_share": device_ms / (wall * 1e3) if device_ms else None,
            "kernels_top_ms_per_step": [{"name": k[:100], "ms": ms, "calls": c}
                                        for k, ms, c in top[:12]]}


def decode_profile(model, params, prompts: list, steps: int = 8) -> dict:
    """The continuous engine's decode step at 8 busy slots: host ms per step
    (synchronised), then under ``torch.profiler`` the device time of
    ``steps`` steps and its share of their wall time, beside the step's
    byte bound (every weight but the embedding table read once, plus the
    K/V rows the step attends over: MLA's latent and rope-key rows; for
    a family on the dense slot pool (xlstm) its whole recurrent state,
    read once and written once)."""
    from repro_torch.models.transformer import kv_rows
    from repro_torch.runtime import ContinuousBatchingEngine
    from repro_torch.utils import tree_bytes
    cfg = model.cfg
    eng = ContinuousBatchingEngine(model, params, n_slots=8, max_len=512,
                                   page_size=PAGE_SIZE)
    for p in prompts[:8]:
        eng.submit(p, 2 * steps + 4)
    while eng.queue or eng.n_prefill_calls < len(prompts[:8]):
        eng.step()
    eng.step()
    host = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    rows = int(np.sum(eng._pos))                 # K/V rows of the next step
    state = 0 if model.supports_paged_kv else eng.pool.nbytes()
    prof = profiled_steps([eng.step] * steps)
    eng.close()
    elt = torch.empty((), dtype=model.dtype).element_size()
    embed = params["embed"]
    weights = tree_bytes(params) - embed.numel() * elt + 8 * cfg.d_model * elt
    if model.supports_paged_kv:
        row = sum(int(np.prod(r)) for r in kv_rows(cfg).values())
        kv = rows * cfg.n_layers * row * elt
    else:
        kv = 2 * state
    out = {"arch": cfg.name, "layers": cfg.n_layers, "slots": 8,
           "host_ms_per_step_median": float(np.median(host) * 1e3),
           "host_ms_per_step_min": float(np.min(host) * 1e3),
           **prof, "weight_bytes": weights, "kv_bytes": kv,
           "bound_ms": (weights + kv) / HBM_BYTES_PER_S * 1e3}
    print(json.dumps({"decode_step": out}))
    return out


def big_faas(model, params, h2d: float, lora_target=None, prompts=None,
             state_bytes: int = 0) -> dict:
    """``FaaSRuntime`` over a model of GBs with one function: a static one
    with the 131-token template prompt (without it when ``prompts`` are
    given: a recurrent family has no template prompt, and its prompts
    keep its chunk rule), or with ``lora_target`` a LoRA function (2
    adapters), served cold, warm, then forked after an evict (the LoRA one
    on the other adapter) and warm again, through the gateway.  The template server keeps no
    weights resident (``device_budget_bytes=0``): every fork streams the
    whole model, and the card holds the function's weights and one
    forked copy.  A fork's tokens equal the warm invocation's for the
    same prompt and event.  One function per runtime: a function holds
    its host checkpoint and its pinned pool, each the model's bytes.  The
    page-locked bytes after deploy must stay within 1.05 times the
    model's (the pool's exact size; a pool pinned leaf by leaf held 1.7
    times it for llama2-13b).  ``state_bytes``: the dense slot pool's
    recurrent state and the prewarm's copy of it, allowed at peak beside
    the weights."""
    from repro_torch.core import api as tidal
    from repro_torch.core.template_server import TemplateServer
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.runtime import FaaSRuntime
    from repro_torch.utils import tensor_nbytes
    prefix, reqs = serving_workload(model.cfg.vocab_size)
    if prompts is not None:
        prefix, reqs = None, prompts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt = FaaSRuntime(server=TemplateServer(hw=H100_SXM.with_h2d(h2d), trace_seq=128,
                                           device_budget_bytes=0),
                     n_slots=8, max_len=512, page_size=PAGE_SIZE,
                     device=model.device)
    t0 = time.perf_counter()
    a0, a1 = {"adapter": "adapter-0"}, {"adapter": "adapter-1"}
    if lora_target is None:
        name = "static"
        rt.deploy(tidal.static_function(name, model, params), {},
                  prewarm_seq=128, template_prompt=prefix)
        waves = [[(name, {}, 0)], [(name, {}, 1)], "evict", [(name, {}, 0)],
                 [(name, {}, 0)]]
    else:
        name = "lora"
        rt.deploy(tidal.lora_function(name, model, params, [lora_target],
                                      n_adapters=2), a0, prewarm_seq=128)
        waves = [[(name, a0, 3)], [(name, a0, 4)], "evict", [(name, a1, 3)],
                 [(name, a1, 3)]]
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    model_bytes = rt.server.templates[name].total_bytes
    pinned = {**pinned_bytes(rt.server), **meminfo(), "host_pool_bytes": sum(
        tensor_nbytes(t) for pool in rt.server.host_pool.values()
        for t in pool.values()), "host_buffer_bytes": sum(
        b.nbytes for b in rt.server.host_buffers.values())}
    view = next(iter(rt.server.host_pool[name].values()))
    pinned["pool_views_pinned"] = view.is_pinned()
    print(json.dumps({"after_deploy": {"arch": model.cfg.name, **pinned,
                                       "model_bytes": model_bytes}}))
    if not pinned["pool_views_pinned"] or pinned["pinned_bytes"] > 1.05 * model_bytes:
        raise AssertionError(f"{model.cfg.name}: {pinned['pinned_bytes']} bytes "
                             f"page-locked for {model_bytes} of weights: {pinned}")
    results = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for wave in waves:
        if wave == "evict":
            rt.evict()
            continue
        outs = rt.submit_many([(fn, ev, reqs[i], 16) for fn, ev, i in wave])
        results += [(fn, i, r) for (fn, _, i), r in zip(wave, outs)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    kinds = [r.kind for *_, r in results]
    want = ["cold", "warm", "fork", "warm"]
    if kinds != want:
        raise AssertionError(f"{model.cfg.name} service kinds {kinds} != {want}")
    if any(r.status != "done" or len(r.tokens) != 16 for *_, r in results):
        raise AssertionError(f"{model.cfg.name}: unfinished invocations")
    forked = [(fn, r) for fn, _, r in results if r.fork_stats is not None]
    for fn, r in forked:
        fs = r.fork_stats
        total = rt.server.templates[fn].total_bytes
        if not r.streamed_prefill or fs.reused_bytes or (
                fs.streamed_bytes + fs.dynamic_bytes != total):
            raise AssertionError(f"{fn} fork: streamed prefill {r.streamed_prefill}, "
                                 f"bytes {fs} != {total}")
    for j, (fn, i, r) in enumerate(results):
        if r.kind == "fork":        # the next invocation: the same one, warm
            fn2, i2, warm = results[j + 1]
            if (fn2, i2, warm.kind) != (fn, i, "warm") or not np.array_equal(
                    r.tokens, warm.tokens):
                raise AssertionError(f"{fn}: fork tokens != warm tokens")
    check_norm_launches(counts, model.cfg, f"{model.cfg.name} FaaS")
    if model.supports_paged_kv and not model.cfg.use_mla and (
            counts["paged_decode_attention"] == 0 or counts["flash_attention"] == 0
            or counts["decode_attention"] or counts["ssd_scan"]):
        raise AssertionError(f"{model.cfg.name} FaaS launches {counts}")
    peak = torch.cuda.max_memory_allocated()
    out = {"arch": model.cfg.name, "function": name, "lora_target": lora_target,
           "deploy_s": deploy_s, "model_bytes": model_bytes,
           "kinds": kinds, "wall_s": wall, "launches": counts,
           "ttft_ms": [{"fn": fn, "kind": r.kind, "ms": r.ttft_s * 1e3,
                        "reused_prefix_len": r.reused_prefix_len}
                       for fn, _, r in results],
           "fork_bytes": [{"fn": fn, "streamed": r.fork_stats.streamed_bytes,
                           "dynamic": r.fork_stats.dynamic_bytes,
                           "fork_s": r.fork_stats.fork_s} for fn, r in forked],
           "max_memory_allocated": peak,
           "max_memory_allocated_per_model_bytes": peak / model_bytes,
           "after_deploy": pinned}
    print(json.dumps({"faas": out}))
    rt.evict()
    del rt
    release_host_memory()
    # the function's weights plus one forked copy, and the arena (or the
    # recurrent state) and activations: a third copy would show here
    if peak >= 2.5 * model_bytes + state_bytes:
        raise AssertionError(f"{model.cfg.name}: {peak} bytes allocated at peak, "
                             f"more than 2 copies of {model_bytes} and "
                             f"{state_bytes} of state")
    return out


def phase_llama(device, h2d: float) -> dict:
    """llama2-13b at full width and depth (40 layers, d_model 5120, 40
    heads of 128 for queries and keys, bf16, 26 GB): the paged serving
    passes (bf16 and int8 arenas), the sequential Engine against the
    continuous engine, the decode step against its weight-byte bound,
    ``FaaSRuntime`` cold / warm / fork; then a 2-layer fp32 card against
    CPU check and streamed prefill."""
    from repro_torch.models.registry import get_config
    model, params, info = big_model("llama2-13b", device)
    cfg = model.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim) == (40, 5120, 40, 40, 128)
    out = {"model": info}
    out["serve"], _ = phase_serve(model, params, passes=(
        ("paged", {}), ("int8", {"kv_dtype": "int8"})))
    prompts = np.random.default_rng(5).integers(1, cfg.vocab_size, (8, 256)
                                                ).astype(np.int32)
    out["engine"] = engine_vs_continuous(model, params, prompts, 32, 8,
                                         per_prompt=False)
    out["decode_step"] = decode_profile(model, params, list(prompts))
    out["faas"] = big_faas(model, params, h2d)
    del model, params
    torch.cuda.empty_cache()
    out["parity"] = card_cpu_parity(
        get_config("llama2-13b").replace(n_layers=2, dtype="float32"), device)
    return out


def phase_moe(device, h2d: float) -> dict:
    """phi3.5-moe-42b-a6.6b at full width (d_model 4096, 32 / 8 heads of
    128, 16 experts of 6400, top-2, capacity factor 1.25, bf16) and the
    largest depth that fits (``fitting_depth``): the paged serving passes
    at 8 slots (plain, chunked, int8), the (token, k) pairs their capacity
    drops, the plain and chunked passes again at cf = E/K (dropless) and a
    384-token prompt prefilled whole and in 64-token chunks there (fp32 at
    one layer: the same expert choices, logits within 1e-3), a 4-slot pass
    (decode dropless) equal to the sequential Engine, the decode step against its byte bound (every expert's weights
    are read), ``FaaSRuntime`` with a static and a LoRA function; then
    1-layer fp32 card against CPU checks (routing and drops equal) at 2
    slots, and at 8 slots with a chunked prefill (both drop pairs), and
    streamed prefill."""
    from repro_torch.models import moe
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.models.transformer import to_device
    full = get_config("phi3.5-moe-42b-a6.6b")
    fit = fitting_depth(full, device, cap=MOE_MAX_LAYERS)
    model, params, info = big_model("phi3.5-moe-42b-a6.6b", device,
                                    n_layers=fit["depth"])
    cfg = model.cfg
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.n_experts, cfg.top_k,
            cfg.moe_d_ff, cfg.capacity_factor) == (4096, 32, 8, 16, 2, 6400, 1.25)
    info["reduced"] = (f"n_layers {full.n_layers} -> {cfg.n_layers} "
                       f"({fit['limited_by']})")
    info["fitting_depth"] = fit
    print(f"phi3.5-moe-42b-a6.6b reduced: {info['reduced']} (full width; "
          f"{info['param_bytes'] / 1e9:.1f} GB of weights)")
    out = {"model": info}
    out["serve"], base = phase_serve(model, params)
    prefix, reqs = serving_workload(cfg.vocab_size)
    eng = serving_engine(model, params, prefix)
    with moe.watch() as calls:
        ids = [eng.submit(p, 16) for p in reqs]
        results = eng.run()
    eng.close()
    same = sum(int((results[i].tokens == t).sum()) for i, t in zip(ids, base))
    drops = moe_drops(calls)
    drops["tokens_equal_to_plain_pass"] = f"{same}/{16 * len(base)}"
    print(json.dumps({"moe_drops_8_slots": drops}))
    if same != 16 * len(base) or not drops["decode_dropped"]:
        raise AssertionError(f"8-slot drop count pass: {drops}")
    out["drops_8_slots"] = drops
    # the chunked pass without drops (cf = E/K): the tokens it shares
    # with the plain pass, and one prompt prefilled whole and in chunks
    dropless_cf = cfg.n_experts / cfg.top_k
    dropless = get_model(cfg.replace(capacity_factor=dropless_cf), device=device)
    with moe.watch() as calls:
        out["serve_dropless"], _ = phase_serve(dropless, params,
                                               passes=SERVE_PASSES[:2])
    out["serve_dropless_drops"] = moe_drops(calls)
    if out["serve_dropless_drops"]["decode_dropped"] or (
            out["serve_dropless_drops"]["prefill_dropped"]):
        raise AssertionError(f"cf = E/K dropped pairs: {out['serve_dropless_drops']}")
    witness_prompt = np.random.default_rng(8).integers(1, cfg.vocab_size, 384
                                                       ).astype(np.int32)
    out["chunked_witness"] = [chunked_prefill_witness(dropless, params,
                                                      witness_prompt, 64)]
    prompts = np.random.default_rng(6).integers(1, cfg.vocab_size, (4, 256)
                                                ).astype(np.int32)
    with moe.watch() as calls:
        out["engine"] = engine_vs_continuous(model, params, prompts, 16, 4,
                                             per_prompt=True)
    out["engine"]["drops"] = moe_drops(calls)
    if out["engine"]["drops"]["decode_dropped"]:
        raise AssertionError(f"4-slot decode dropped pairs: {out['engine']['drops']}")
    dec_prompts = np.random.default_rng(7).integers(1, cfg.vocab_size, (8, 256))
    out["decode_step"] = decode_profile(model, params,
                                        list(dec_prompts.astype(np.int32)))
    out["faas"] = big_faas(model, params, h2d)
    out["faas_lora"] = big_faas(model, params, h2d, lora_target="blocks.attn.wq")
    del model, params, dropless
    torch.cuda.empty_cache()
    small = full.replace(n_layers=1, dtype="float32")
    # chunking on the card at fp32 changes no expert choice and moves the
    # logits by rounding only; the same weights in bf16 are printed beside
    one = get_model(small.replace(capacity_factor=dropless_cf), device=device)
    one_params = one.init_params(seed=1)
    fp32 = chunked_prefill_witness(one, one_params, witness_prompt, 64)
    one_bf16 = get_model(one.cfg.replace(dtype="bfloat16"), device=device)
    out["chunked_witness"] += [fp32, chunked_prefill_witness(
        one_bf16, to_device(one_params, device, torch.bfloat16), witness_prompt, 64)]
    del one, one_params, one_bf16
    if fp32["routes_differ"] or fp32["max_abs_logit_diff"] > 1e-3:
        raise AssertionError(f"chunked prefill differs from the whole prefill: {fp32}")
    cpu_params = get_model(small, device="cpu").init_params(seed=1)
    out["parity"] = card_cpu_parity(small, device, cpu_params=cpu_params)
    out["parity_8_slots"] = card_cpu_parity(small, device, n_slots=8, chunk=48,
                                            cpu_params=cpu_params)
    got = out["parity_8_slots"]["drops_card"]
    if not (got["decode_dropped"] and got["prefill_dropped"]):
        raise AssertionError(f"the 8-slot, chunked card against CPU check "
                             f"dropped no pairs: {got}")
    return out


def latent_arena_bytes(model) -> dict:
    """Bytes per token per layer of the latent paged arena (bf16 and int8
    with its scales), beside a GQA cache's at the model's heads (K and V,
    ``n_heads`` of ``v_head_dim``, bf16)."""
    from repro_torch.runtime import PagedKVCachePool
    cfg, out = model.cfg, {}
    for kv_dtype in (None, "int8"):
        pool = PagedKVCachePool(model, n_slots=1, max_len=PAGE_SIZE,
                                page_size=PAGE_SIZE, kv_dtype=kv_dtype)
        out[kv_dtype or str(model.dtype)[6:]] = pool.page_nbytes() / (
            PAGE_SIZE * cfg.n_layers)
        del pool
    elt = torch.empty((), dtype=model.dtype).element_size()
    out["gqa_same_heads"] = 2 * cfg.n_heads * cfg.v_head_dim * elt
    out["gqa_over_latent"] = out["gqa_same_heads"] / out[str(model.dtype)[6:]]
    print(json.dumps({"latent_arena_bytes_per_token_per_layer": out}))
    row = cfg.kv_lora_rank + cfg.qk_rope_dim
    if (out[str(model.dtype)[6:]], out["int8"]) != (row * elt, row + 8):
        raise AssertionError(f"latent arena bytes {out}, rows of {row}")
    return out


def phase_deepseek(device, h2d: float) -> dict:
    """deepseek-v3-671b at full width (d_model 7168, 128 heads; MLA ranks
    1536 / 512, dims 128 / 64 / 128; 256 experts of 2048, top-8, one
    shared expert; capacity factor 1.25; vocabulary 129,280; bf16) at the
    depth ``fitting_depth`` works out (one of 61 layers is 23 GB): the
    paged serving passes at 8 slots (plain, chunked, int8) over the latent
    arena, the (token, k) pairs the capacity drops (an untimed pass), a
    dropless (cf = E/K) 8-slot pass equal to the sequential ``Engine`` run
    prompt by prompt, the arena's bytes per token, the decode step beside
    its byte bound, ``FaaSRuntime`` cold / warm / fork of a static
    function; then 1-layer fp32 card against CPU checks with the experts
    cut to 32 (logits within 1e-4 of the largest, routing and kept pairs
    equal) at 2 slots and at 8 slots with a 48-token chunked prefill, and
    streamed prefill equal to prefill.  No attention kernel runs (MLA
    attends in PyTorch ops); rmsnorm launches 4L+1 per model call."""
    from repro_torch.models import moe
    from repro_torch.models.registry import get_config, get_model
    full = get_config("deepseek-v3-671b")
    fit = fitting_depth(full, device)
    model, params, info = big_model("deepseek-v3-671b", device,
                                    n_layers=fit["depth"])
    cfg = model.cfg
    assert (cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank,
            cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.n_experts,
            cfg.top_k, cfg.n_shared_experts, cfg.moe_d_ff, cfg.vocab_size,
            cfg.capacity_factor) == (7168, 128, 1536, 512, 128, 64, 128, 256,
                                     8, 1, 2048, 129280, 1.25)
    info["reduced"] = (f"n_layers {full.n_layers} -> {cfg.n_layers} "
                       f"({fit['limited_by']})")
    info["fitting_depth"] = fit
    print(f"deepseek-v3-671b reduced: {info['reduced']} (full width; "
          f"{info['param_bytes'] / 1e9:.1f} GB of weights)")
    out = {"model": info}
    out["serve"], base = phase_serve(model, params)
    prefix, reqs = serving_workload(cfg.vocab_size)
    eng = serving_engine(model, params, prefix)
    with moe.watch() as calls:
        ids = [eng.submit(p, 16) for p in reqs]
        results = eng.run()
    eng.close()
    same = sum(int((results[i].tokens == t).sum()) for i, t in zip(ids, base))
    drops = moe_drops(calls)
    drops["tokens_equal_to_plain_pass"] = f"{same}/{16 * len(base)}"
    print(json.dumps({"moe_drops_8_slots": {"arch": cfg.name, **drops}}))
    if same != 16 * len(base):
        raise AssertionError(f"the drop count pass differs from the plain pass: {drops}")
    out["drops_8_slots"] = drops
    dropless = get_model(cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k),
                         device=device)
    prompts = np.random.default_rng(6).integers(1, cfg.vocab_size, (8, 256)
                                                ).astype(np.int32)
    with moe.watch() as calls:
        out["engine"] = engine_vs_continuous(dropless, params, prompts, 16, 8,
                                             per_prompt=True)
    out["engine"]["drops"] = moe_drops(calls)
    if out["engine"]["drops"]["decode_dropped"] or (
            out["engine"]["drops"]["prefill_dropped"]):
        raise AssertionError(f"cf = E/K dropped pairs: {out['engine']['drops']}")
    out["arena"] = latent_arena_bytes(model)
    dec_prompts = np.random.default_rng(7).integers(1, cfg.vocab_size, (8, 256))
    out["decode_step"] = decode_profile(model, params,
                                        list(dec_prompts.astype(np.int32)))
    out["faas"] = big_faas(model, params, h2d)
    del model, params, dropless
    torch.cuda.empty_cache()
    release_host_memory()
    small = full.replace(n_layers=1, dtype="float32",
                         n_experts=DEEPSEEK_PARITY_EXPERTS)
    print(f"deepseek-v3-671b parity reduced: n_layers {full.n_layers} -> 1, "
          f"n_experts {full.n_experts} -> {DEEPSEEK_PARITY_EXPERTS} (fp32 on the "
          f"card and on the CPU; every other width the config's)")
    cpu_params = get_model(small, device="cpu").init_params(seed=1)
    out["parity"] = card_cpu_parity(small, device, cpu_params=cpu_params)
    out["parity_8_slots"] = card_cpu_parity(small, device, n_slots=8, chunk=48,
                                            cpu_params=cpu_params)
    return out


# ---------------------------------------------------------------------------
# phase 12: xlstm-1.3b at full width and depth
# ---------------------------------------------------------------------------

# xLSTM's rows: the block norms at d_model 2048 and the mLSTM inner norm
# at d_inner 4096, at decode (8 slots) and at a 512-token prefill
XLSTM_RMSNORM_CASES = (("xlstm-decode", (8, 1, 2048)),
                       ("xlstm-inner-decode", (8, 1, 4096)),
                       ("xlstm-prefill", (512, 2048)),
                       ("xlstm-inner-prefill", (512, 4096)))
# prompt lengths the reference's chunked mLSTM takes at ssm_chunk 128: at
# most one chunk, or a multiple of it
XLSTM_LENGTHS = (32, 64, 96, 128, 256, 384, 512)


def xlstm_prefill_timing(model, params, S: int = 512, reps: int = 3) -> dict:
    """One S-token prefill: its wall ms (synchronised) and the ms until
    the call returned to the host (median of ``reps``); then one run with
    the card synchronised around each sLSTM mixer, whose time loop runs S
    steps of ~15 ops per sLSTM block, for that loop's share of the wall."""
    from repro_torch.models import ssm
    toks = np.random.default_rng(21).integers(1, model.cfg.vocab_size, (1, S)
                                              ).astype(np.int32)

    def run():
        cache = model.make_cache(1, S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, cache)
        t_call = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t_call, time.perf_counter() - t0

    run()                                                  # warm-up
    calls, walls = zip(*[run() for _ in range(reps)])
    mixer, spent = ssm.slstm_mixer, []

    def timed_slstm(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = mixer(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    ssm.slstm_mixer = timed_slstm
    try:
        _, wall_i = run()
    finally:
        ssm.slstm_mixer = mixer
    out = {"prompt_len": S, "wall_ms_median": float(np.median(walls) * 1e3),
           "host_ms_median": float(np.median(calls) * 1e3),
           "instrumented_wall_ms": wall_i * 1e3,
           "slstm_ms": float(np.sum(spent) * 1e3), "slstm_calls": len(spent),
           "slstm_share": float(np.sum(spent) / wall_i)}
    print(json.dumps({"xlstm_prefill": out}))
    return out


def xlstm_parity(device) -> dict:
    """A 2-layer fp32 xlstm-1.3b at full width (``slstm_every`` 2: one
    mLSTM and one sLSTM block): ``recurrent_parity`` on two 256-token
    prompts (two mLSTM chunks), logits within 1e-4 of the largest."""
    from repro_torch.models.registry import get_config
    cfg = get_config("xlstm-1.3b").replace(n_layers=2, slstm_every=2,
                                           dtype="float32")
    print("xlstm-1.3b parity reduced: n_layers 48 -> 2, slstm_every 8 -> 2 "
          "(fp32 on the card and on the CPU; every width the config's)")
    prompts = np.random.default_rng(22).integers(1, cfg.vocab_size, (2, 256)
                                                 ).astype(np.int32)
    return recurrent_parity(cfg, device, prompts, lambda m: 1e-4 * m, "xlstm",
                            128)


def phase_xlstm(device, h2d: float) -> dict:
    """xlstm-1.3b at full width and depth (48 layers: 42 mLSTM and 6 sLSTM
    blocks, d_model 2048, 4 heads, mLSTM head dim 1024, chunk 128, bf16,
    7.21 GB of seeded random weights drawn leaf by leaf): rmsnorm at
    xLSTM's rows, the dense-pool continuous engine (8 slots, 12 requests),
    the sequential Engine (8 x 256 + 32) with the continuous engine's
    tokens equal to it, exact launch counts (rmsnorm 103 per model call, 6
    fused; no attention kernel, no ``ssd_scan``), the decode step at 8
    busy slots beside its byte bound (weights, and the recurrent state read
    and written), a 512-token prefill and its sLSTM loop's share,
    ``FaaSRuntime`` cold / warm / fork of a static function (a fork
    streams the whole model), the peak allocation; then a 2-layer fp32
    card against CPU check and streamed prefill equal to prefill."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import make_cache
    from repro_torch.runtime import Engine
    from repro_torch.utils import tree_bytes
    gen = torch.Generator().manual_seed(12)
    rows = []
    for tag, shape in XLSTM_RMSNORM_CASES:
        rows += rmsnorm_case(device, gen, tag, shape, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    model, params, info = big_model("xlstm-1.3b", device)
    cfg = model.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.slstm_every,
            cfg.mlstm_proj_factor, cfg.ssm_chunk, cfg.conv_width,
            cfg.vocab_size) == (48, 2048, 4, 8, 2.0, 128, 4, 50304)
    per_call = (norm_launches(cfg), fused_norm_launches(cfg))
    if per_call != (103, 6):
        raise AssertionError(f"xlstm-1.3b rmsnorm launches per call {per_call}")
    slot_bytes = tree_bytes(make_cache(cfg, 1, 512, device="meta"))
    out = {"model": info, "kernels": rows, "rmsnorm_per_call": per_call,
           "state_bytes_per_slot": slot_bytes}
    rng = np.random.default_rng(20)
    lengths = list(XLSTM_LENGTHS) + list(rng.choice(XLSTM_LENGTHS, 5))
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lengths]
    dense_continuous(model, params, prompts[:2], 2, "xlstm warm-up", 1024)
    out["serve"], _ = dense_continuous(model, params, prompts, 16,
                                       "xlstm dense pool", 1024)

    batch = np.random.default_rng(23).integers(1, cfg.vocab_size, (8, 256)
                                               ).astype(np.int32)
    eng = Engine(model, params)
    eng.generate(batch[:, :32], max_new_tokens=2)             # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate(batch, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    # the Engine's batch of 8 prefills one sequence at a time (8 calls),
    # then 31 decode steps of the batch
    check_xlstm_launches(counts, cfg, 8 + 31, "xlstm Engine")
    cont, cont_tokens = dense_continuous(model, params, list(batch), 32,
                                         "xlstm dense pool, Engine's prompts")
    equal = sum(int((res.tokens[i] == t).sum()) for i, t in enumerate(cont_tokens))
    engine = {"pass": "xlstm engine", "batch": 8, "prompt_len": 256,
              "new_tokens": 32, "launches": counts, "wall_s": wall,
              "ttft_ms": res.ttft_s * 1e3,
              "decode_ms_per_step": res.decode_s / 31 * 1e3,
              "tokens_per_s": 8 * 32 / wall,
              "tokens_equal_to_continuous": f"{equal}/{8 * 32}"}
    print(json.dumps(engine))
    if equal != 8 * 32:
        raise AssertionError(f"xlstm Engine tokens differ from the continuous "
                             f"engine's: {equal}/{8 * 32}")
    out["engine"], out["engine_prompts_continuous"] = engine, cont
    out["decode_step"] = decode_profile(model, params, list(batch))
    out["prefill_512"] = xlstm_prefill_timing(model, params)
    peak = {"serving_max_memory_allocated": torch.cuda.max_memory_allocated(),
            "param_bytes": info["param_bytes"],
            "pool_state_bytes_8_slots": 8 * slot_bytes}
    faas_prompts = [prompts[i] for i in (3, 4, 5, 1, 2)]      # 128, 256, 384, ...
    out["faas"] = big_faas(model, params, h2d, prompts=faas_prompts,
                           state_bytes=9 * slot_bytes)
    out["peak"] = peak = {**peak, "faas_max_memory_allocated":
                          out["faas"]["max_memory_allocated"]}
    print(json.dumps({"xlstm_peak": peak}))
    del model, params, eng
    torch.cuda.empty_cache()
    out["parity"] = xlstm_parity(device)
    return out


# whisper-medium's attention heads (16 / 16 / 64, G = 1) and serving shape
WHISPER = dict(H=16, KV=16, d=64)
WHISPER_FRAMES = 1500            # the 30 s window
WHISPER_BATCH = 8
WHISPER_PROMPT = 4
WHISPER_NEW = 444                # prompt + 444 - 1 = 447 of 448 decoder rows


def whisper_kernel_cases(device) -> list:
    """The attention kernels at whisper-medium's heads, bf16 and fp32,
    each against its plain version, timed beside SDPA and the bound:
    flash non-causal at B = 8 over 1,500 keys with S = 1,500 (the encoder)
    and S = 4 (cross-attention of a 4-token prompt), flash causal at S = T
    = 64 (decoder self-attention), decode at B = 8 over 1,500 rows at one
    length (cross) and over 448 rows at per-sequence lengths (self)."""
    gen = torch.Generator().manual_seed(13)
    rng = np.random.default_rng(13)
    T, B = WHISPER_FRAMES, WHISPER_BATCH
    self_lengths = rng.integers(1, 449, B).tolist()
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for S, Tk, causal in ((T, T, False), (WHISPER_PROMPT, T, False),
                              (64, 64, True)):
            rows.append(flash_case(device, gen, "whisper-medium", WHISPER, B,
                                   S, Tk, dtype, 0.0, causal))
        rows.append(decode_case(device, gen, "cross", "whisper-medium",
                                WHISPER, T, [T] * B, dtype))
        rows.append(decode_case(device, gen, "self", "whisper-medium",
                                WHISPER, 448, self_lengths, dtype))
    return rows


def whisper_step_bytes(params, cfg, B: int, T: int, positions) -> dict:
    """Bytes one decode step must move at each of ``positions``, averaged:
    every decoder layer's weights but the cross K/V projections (``wk``,
    ``wv``, ``bv``: the prefill applied them), the final norm, the tied
    head (the whole embedding table), B embedding rows and one position
    row; the cross K/V (B x Ld x T rows of K and V); the self K/V rows 0
    .. pos read and row pos written; the logits written.  No encoder
    weight."""
    from repro_torch.utils import named_leaves, tensor_nbytes
    elt = torch.empty((), dtype=params["embed"].dtype).element_size()
    D, Ld = cfg.d_model, cfg.dec_layers
    weights = sum(tensor_nbytes(t) for path, t in named_leaves(params["dec_layers"])
                  if path.split(".", 1)[1] not in ("cross_attn.wk", "cross_attn.wv",
                                                   "cross_attn.bv"))
    weights += (sum(tensor_nbytes(t) for _, t in named_leaves(params["dec_ln"]))
                + tensor_nbytes(params["embed"]) + (B + 1) * D * elt)
    row = 2 * cfg.n_heads * cfg.head_dim * elt          # one K and one V row
    cross = B * Ld * T * row
    self_kv = float(np.mean([B * Ld * (p + 2) * row for p in positions]))
    logits = B * cfg.vocab_size * elt
    total = weights + cross + self_kv + logits
    return {"weight_bytes": weights, "cross_kv_bytes": cross,
            "self_kv_bytes": self_kv, "logit_bytes": logits,
            "total_bytes": total,
            "bound_ms": total / HBM_BYTES_PER_S * 1e3}


def whisper_decode_profile(model, params, cache, steps: int = 8) -> dict:
    """Decode steps of the batch over a filled cache (the ``Engine``
    run's, positions 429 to 446): host ms per step (synchronised), then
    under ``torch.profiler`` the device time of ``steps`` steps and its
    share of their wall time, beside the byte bound."""
    cfg = model.cfg
    B = cache["self_kv"]["k"].shape[1]
    T = cache["cross_kv"]["k"].shape[2]
    toks = torch.ones((B, 1), dtype=torch.int32, device=model.device)
    pos0 = cfg.max_dec_len - 2 - (2 * steps + 2) + 1
    model.decode_step(params, cache, {"tokens": toks}, pos0)        # warm-up
    model.decode_step(params, cache, {"tokens": toks}, pos0 + 1)
    host = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_step(params, cache, {"tokens": toks}, pos0 + 2 + i)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    positions = [pos0 + 2 + steps + i for i in range(steps)]
    prof = profiled_steps([
        lambda p=p: model.decode_step(params, cache, {"tokens": toks}, p)
        for p in positions])
    out = {"arch": cfg.name, "batch": B, "positions": [positions[0], positions[-1]],
           "host_ms_per_step_median": float(np.median(host) * 1e3), **prof,
           **whisper_step_bytes(params, cfg, B, T, positions)}
    print(json.dumps({"whisper_decode_step": out}))
    return out


def whisper_parity(device) -> dict:
    """A 2 + 2-layer fp32 whisper-medium at full width: the same seeded
    weights on the card (kernels) and on the CPU (plain versions), 1,500
    frames and 4-token prompts at B = 2, then 15 greedy decode steps
    through the ``Engine``: logits within 1e-4 of the largest |logit|,
    tokens equal over the 16."""
    from repro_torch.data.pipeline import make_frames
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.runtime import Engine
    cfg = get_config("whisper-medium").replace(n_layers=2, dec_layers=2,
                                               dtype="float32")
    print("whisper-medium parity reduced: n_layers 24 -> 2, dec_layers 24 -> "
          "2 (fp32 on the card and on the CPU; every width the config's)")
    frames = make_frames(cfg.d_model, 2, WHISPER_FRAMES, seed=31)
    prompts = np.random.default_rng(31).integers(1, cfg.vocab_size, (2, 4)
                                                 ).astype(np.int32)
    runs = {}
    for dev in (device, "cpu"):
        model = get_model(cfg, device=dev)
        logits = []

        def prefill(p, inputs, cache, m=model, out=logits):
            lg, cache = m.prefill(p, inputs, cache)
            out.append(lg.float().cpu())
            return lg, cache

        def decode(p, cache, inputs, pos, m=model, out=logits):
            lg, cache = m.decode_step(p, cache, inputs, pos)
            out.append(lg.float().cpu())
            return lg, cache

        res = Engine(model, model.init_params(seed=1), prefill, decode
                     ).generate(prompts, max_new_tokens=16, frames=frames)
        runs[str(dev)] = (torch.stack(logits), res.tokens)
    (lg_gpu, tk_gpu), (lg_cpu, tk_cpu) = runs[str(device)], runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    big = float(lg_cpu.abs().max())
    out = {"config": f"{cfg.name} x {cfg.n_layers} + {cfg.dec_layers} layers, "
           f"{cfg.dtype}", "frames": WHISPER_FRAMES, "steps": 16,
           "max_abs_logit_err": err, "max_abs_logit": big, "tol": 1e-4 * big,
           "tokens_equal": bool((tk_gpu == tk_cpu).all()),
           "tokens_card": tk_gpu.tolist()}
    print(json.dumps({"whisper_parity": out}))
    if not err <= out["tol"] or not out["tokens_equal"]:
        raise AssertionError(f"whisper card vs CPU parity failed: {out}")
    return out


def check_whisper_launches(counts: dict, cfg, prefills: int, steps: int,
                           where: str) -> None:
    """Exact launches: 3 flash per decoder layer pair per prefill (encoder,
    decoder self, cross), 2 ``decode_attention`` per decoder layer per
    step, and nothing else."""
    want = {"flash_attention": prefills * (cfg.n_layers + 2 * cfg.dec_layers),
            "decode_attention": steps * 2 * cfg.dec_layers,
            "paged_decode_attention": 0, "rmsnorm": 0, "rmsnorm_fused": 0,
            "ssd_scan": 0, **NO_BACKWARD}
    if counts != want:
        raise AssertionError(f"{where}: launches {counts}, want {want}")


def phase_whisper(device) -> dict:
    """whisper-medium at full width and depth (24 encoder and 24 decoder
    layers, d_model 1024, 16 heads of 64, d_ff 4096, vocabulary 51,865,
    tied head, 448 decoder positions; bf16, seeded random weights): the
    attention kernels at its shapes, then ``Engine.generate(frames=)`` at
    8 sequences over 1,500 frames with 4-token prompts and 444 new tokens
    (exact launches: 72 flash per prefill, 48 ``decode_attention`` per
    step, no other kernel), each sequence alone against the batch (32
    tokens, information only), the decode step beside its byte bound,
    the peak allocation, ``ContinuousBatchingEngine`` refusing the model,
    then a 2 + 2-layer fp32 card against CPU check."""
    from repro_torch.data.pipeline import make_frames
    from repro_torch.kernels import ops
    from repro_torch.runtime import ContinuousBatchingEngine, Engine
    rows = whisper_kernel_cases(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, params, info = big_model("whisper-medium", device)
    cfg = model.cfg
    assert (cfg.n_layers, cfg.dec_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.max_dec_len) == (
        24, 24, 1024, 16, 64, 4096, 51865, 448)
    B, S, new = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW
    frames = make_frames(cfg.d_model, B, WHISPER_FRAMES, seed=30)
    prompts = np.random.default_rng(30).integers(1, cfg.vocab_size, (B, S)
                                                 ).astype(np.int32)
    kept = {}

    def decode(p, cache, inputs, pos):
        kept["cache"] = cache
        return model.decode_step(p, cache, inputs, pos)

    eng = Engine(model, params, decode_fn=decode)
    eng.generate(prompts, max_new_tokens=2, frames=frames)          # warm-up
    torch.cuda.synchronize()
    stamps = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=new, frames=frames,
                       on_token=lambda toks, i: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_whisper_launches(counts, cfg, 1, new - 1, "whisper Engine")
    peak = torch.cuda.max_memory_allocated()
    engine = {"pass": "whisper engine", "batch": B, "frames": WHISPER_FRAMES,
              "prompt_len": S, "new_tokens": new, "launches": counts,
              "wall_s": wall, "ttft_ms": res.ttft_s * 1e3,
              "decode_ms_per_step_median": float(np.median(np.diff(stamps)) * 1e3),
              "decode_ms_per_step_mean": res.decode_s / (new - 1) * 1e3,
              "tokens_per_s": B * new / wall,
              "max_memory_allocated": peak, "param_bytes": info["param_bytes"]}
    print(json.dumps(engine))
    alone = []
    for b in range(B):
        one = Engine(model, params).generate(prompts[b:b + 1], max_new_tokens=32,
                                             frames=frames[b:b + 1])
        alone.append(bool((one.tokens[0] == res.tokens[b, :32]).all()))
    engine["alone_equal_to_batch_32_tokens"] = f"{sum(alone)}/{B}"
    print(json.dumps({"whisper_alone_vs_batch": engine[
        "alone_equal_to_batch_32_tokens"], "per_sequence": alone}))
    out = {"model": info, "kernels": rows, "engine": engine,
           "decode_step": whisper_decode_profile(model, params, kept["cache"])}
    try:
        ContinuousBatchingEngine(model, params)
    except NotImplementedError as e:
        out["continuous_refused"] = str(e)
    else:
        raise AssertionError("ContinuousBatchingEngine took an enc-dec model")
    del model, params, eng, kept
    torch.cuda.empty_cache()
    out["parity"] = whisper_parity(device)
    return out


# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------

PHI_MOE = dict(H=32, KV=8, d=128)
TRAIN_STEPS = 20
TRAIN_CKPT_EVERY = 10


def time_grad_ms(forward, inputs: tuple, grad_out, reps: int = 20,
                 graph_calls: int = 10) -> float:
    """Mean device time in ms of one ``torch.autograd.grad`` of
    ``forward(*inputs)`` with respect to ``inputs`` (a library operator's
    backward, timed as ``time_ms`` times a kernel).  The forward is
    captured into one CUDA graph and ``graph_calls`` backward calls into
    a second one in the same pool, as ``torch.cuda.make_graphed_callables``
    does, so the backward runs on the capture stream; the backward graph
    is replayed ``reps`` times between CUDA events, and host launch
    overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            torch.autograd.grad(forward(*inputs), inputs, grad_out)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(fwd):
        out = forward(*inputs)
    with torch.cuda.graph(bwd, pool=fwd.pool()):
        for _ in range(graph_calls):
            torch.autograd.grad(out, inputs, grad_out, retain_graph=True)
    fwd.replay()
    bwd.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        bwd.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * graph_calls)


def max_rel(got, want) -> float:
    """max |got - want| over the largest |want|."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def flash_bwd_case(device, gen, tag, hd, B, S, T, causal=True,
                   softcap=0.0) -> dict:
    """``flash_attention_bwd`` (fp32) against its plain version on the
    card, from the forward kernel's output and log-sum-exp; timed beside
    the plain version, the backward of SDPA through ``autograd.grad``
    under a CUDA graph (none with a softcap) and the bound: 2.5 times the forward's FLOPs at
    the fp32 peak, or q, k, v, o, dO and the lse read and dq, dk, dv
    written once over HBM's rate.  Tolerance 1e-4 of the largest |grad|
    of each of dq, dk and dv."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_launch, _lse_like,
                                                     flash_attention_bwd)
    H, KV, d = hd["H"], hd["KV"], hd["d"]
    f32 = torch.float32
    q = torch.randn((B, S, H, d), generator=gen).to(device).transpose(1, 2)
    k = torch.randn((B, T, KV, d), generator=gen).to(device).transpose(1, 2)
    v = torch.randn((B, T, KV, d), generator=gen).to(device).transpose(1, 2)
    do = torch.randn((B, S, H, d), generator=gen).to(device).transpose(1, 2)
    lse = _lse_like(q)
    o = _launch(q, k, v, causal, softcap, lse)
    o_ref, lse_ref = ref.flash_attention_fwd_ref(q, k, v, causal, softcap)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal, softcap)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal, softcap)
    want = ref.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, causal,
                                       softcap)
    torch.cuda.synchronize()
    errs = {n: max_rel(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    big = B * H * S * T > 2e8
    reps, calls = (3, 2) if big else (20, 10)
    kern_ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal,
                                                  softcap), reps, calls)
    plain_ms = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o_ref, lse_ref, do, causal, softcap), reps, calls)
    lib_ms = None
    if softcap == 0.0:
        lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        mask = (torch.arange(T, device=device)[None, :]
                <= torch.arange(S, device=device)[:, None] + (T - S))
        lib_kw = ({} if not causal else {"is_causal": True} if S == T
                  else {"attn_mask": mask})
        lib_ms = time_grad_ms(lambda a, b, c: sdpa_gqa(a, b, c, **lib_kw),
                              (lq, lk, lv), do, reps, calls)
        del lq, lk, lv
    flops, _ = flash_work(B, H, KV, S, T, d, f32, causal)
    nbytes = 4 * (4 * B * H * S * d + 4 * B * KV * T * d + B * H * S)
    b_ms, b_by = bound_ms(2.5 * flops, nbytes, f32)
    res = {"kernel": "flash_attention_bwd", "shape": tag, "B": B, "H": H,
           "KV": KV, "d": d, "S": S, "T": T, "causal": causal,
           "softcap": softcap, "dtype": "float32",
           "max_abs_err": max(float((g - w).abs().max())
                              for g, w in zip(got, want)),
           "rel_err_of_largest": errs, "tol": "1e-4 of the largest |grad|",
           "deterministic": all(torch.equal(a, b) for a, b in zip(got, again)),
           "lse_max_abs_err": float((lse - lse_ref).abs().max()),
           "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    del want, got, again, o_ref, lse_ref
    if not (max(errs.values()) <= 1e-4 and res["deterministic"]
            and res["lse_max_abs_err"] <= 1e-4):
        raise AssertionError(f"flash_attention_bwd disagrees: {res}")
    return res


def rmsnorm_bwd_case(device, gen, tag, shape, residual=False,
                     stride=None) -> dict:
    """``rmsnorm_bwd`` (fp32) against its plain version, from the forward
    kernel's rstd (and its sum ``s`` in the residual form, where the
    gradient at ``s`` adds to dx), timed beside the plain version, the
    backward of ``F.rms_norm`` (after ``x + r`` in the residual form)
    through ``autograd.grad`` under a CUDA graph and the bound (x, dy, d_sum, rstd and the
    scale read, dx and dscale written once).  Tolerance 1e-5 of the
    largest |value| of dx and of dscale."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fwd
    d = shape[-1]
    x = torch.randn(shape, generator=gen).to(device)
    if stride:
        x = strided_rows(x, stride)
    scale = (torch.randn(d, generator=gen) * 0.1 + 1).to(device)
    r = torch.randn(shape, generator=gen).to(device) if residual else None
    dy = torch.randn(shape, generator=gen).to(device)
    d_sum = torch.randn(shape, generator=gen).to(device) if residual else None
    _, s, rstd = rmsnorm_fwd(x, scale, 1e-5, r)
    xin = s if residual else x
    got = rmsnorm_bwd(xin, scale, dy, 1e-5, d_sum, rstd)
    again = rmsnorm_bwd(xin, scale, dy, 1e-5, d_sum, rstd)
    want = ref.rmsnorm_bwd_ref(xin, scale, dy, 1e-5, d_sum)
    torch.cuda.synchronize()
    errs = {"dx": max_rel(got[0], want[0]), "dscale": max_rel(got[1], want[1])}
    lx, ls = x.detach().clone().requires_grad_(True), scale.clone().requires_grad_(True)
    lr = r.clone().requires_grad_(True) if residual else None
    lib_ms = time_grad_ms(
        lambda a, b, *c: F.rms_norm(a + c[0] if c else a, (d,), b, 1e-5),
        (lx, ls) + ((lr,) if residual else ()), dy)
    n = int(np.prod(shape))
    rows = n // d
    nbytes = 4 * (n * (4 if residual else 3) + 2 * d + rows)
    b_ms, b_by = bound_ms(8 * n, nbytes, torch.float32)
    res = {"kernel": "rmsnorm_bwd" + ("[residual]" if residual else ""),
           "shape": tag, "dims": list(shape), "row_stride": stride or d,
           "dtype": "float32",
           "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
           "rel_err_of_largest": errs, "tol": "1e-5 of the largest |value|",
           "deterministic": all(torch.equal(a, b) for a, b in zip(got, again)),
           "ms": time_ms(lambda: rmsnorm_bwd(xin, scale, dy, 1e-5, d_sum, rstd)),
           "plain_ms": time_ms(lambda: ref.rmsnorm_bwd_ref(xin, scale, dy, 1e-5,
                                                           d_sum)),
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps(res))
    if not (max(errs.values()) <= 1e-5 and res["deterministic"]):
        raise AssertionError(f"rmsnorm_bwd disagrees: {res}")
    return res


def rmsnorm_bwd_many_rows(device) -> dict:
    """``rmsnorm_bwd`` past 65,535 chunks of 64 rows: q_norm's rows at
    batch 8 x seq 16,384 x 40 heads (5,242,880 rows of 128; 81,920
    dscale partials), drawn on the card, against its plain version.
    Correctness only (tolerance 1e-5 of the largest |value| of dx and of
    dscale); the times are those of the training shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fwd
    gen = torch.Generator(device=device).manual_seed(23)
    shape = (8, 16384, 40, 128)
    x = torch.randn(shape, generator=gen, device=device)
    dy = torch.randn(shape, generator=gen, device=device)
    scale = torch.randn(128, generator=gen, device=device) * 0.1 + 1
    _, _, rstd = rmsnorm_fwd(x, scale, 1e-5)
    got = rmsnorm_bwd(x, scale, dy, 1e-5, None, rstd)
    want = ref.rmsnorm_bwd_ref(x, scale, dy, 1e-5)
    errs = {"dx": max_rel(got[0], want[0]), "dscale": max_rel(got[1], want[1])}
    res = {"kernel": "rmsnorm_bwd", "shape": "q_norm-many-rows", "dims": list(shape),
           "rows": x.numel() // 128, "rel_err_of_largest": errs,
           "tol": "1e-5 of the largest |value|"}
    print(json.dumps(res))
    del x, dy, got, want, rstd
    torch.cuda.empty_cache()
    if not max(errs.values()) <= 1e-5:
        raise AssertionError(f"rmsnorm_bwd disagrees past 65,535 chunks: {res}")
    return res


def train_kernel_cases(device) -> list:
    """The backward kernels at the training path's shapes (fp32)."""
    gen = torch.Generator().manual_seed(22)
    rows = [flash_bwd_case(device, gen, "smollm", SMOLLM, 8, 128, 128),
            flash_bwd_case(device, gen, "smollm", SMOLLM, 8, 2048, 2048),
            flash_bwd_case(device, gen, "smollm-softcap", SMOLLM, 2, 256, 256,
                           softcap=30.0),
            flash_bwd_case(device, gen, "phi3.5-moe", PHI_MOE, 2, 512, 512),
            flash_bwd_case(device, gen, "whisper-encoder", WHISPER, 2, 1500, 1500,
                           causal=False),
            flash_bwd_case(device, gen, "whisper-cross", WHISPER, 2, 64, 1500,
                           causal=False)]
    torch.cuda.empty_cache()
    for residual in (False, True):
        rows.append(rmsnorm_bwd_case(device, gen, "smollm-train", (8, 128, 576),
                                     residual))
    # qwen3-14b's q_norm rows (40 heads of 128) read in place, as rows of
    # 128 inside rows of 192
    rows.append(rmsnorm_bwd_case(device, gen, "q_norm-strided", (8, 128, 40, 128),
                                 stride=192))
    rows.append(rmsnorm_bwd_many_rows(device))
    return rows


def tree_equal(a, b) -> bool:
    from repro_torch.utils import named_leaves
    return all(na == nb and torch.equal(x, y) for (na, x), (nb, y)
               in zip(named_leaves(a), named_leaves(b)))


def check_train_launches(counts: dict, want: dict, steps: int, where: str) -> None:
    """Exact launches of ``steps`` training steps, every kernel named
    (``want`` per step; kernels not named must not launch)."""
    expect = {k: 0 for k in counts}
    expect.update({k: n * steps for k, n in want.items()})
    if counts != expect:
        raise AssertionError(f"{where}: launches {counts}, expected {expect}")


def smollm_train_launches(L: int) -> dict:
    """Per training step of a dense model with remat: forward L flash and
    2L + 1 rmsnorm (L fused), recomputed per block in the backward (the
    final norm is not), then one backward per forward call."""
    return {"flash_attention": 2 * L, "rmsnorm": 4 * L + 1, "rmsnorm_fused": 2 * L,
            "flash_attention_bwd": L, "rmsnorm_bwd": 2 * L + 1}


def phase_train(device) -> dict:
    """Phase 14: the backward kernels against their plain versions, then
    ``repro_torch.launch.train``'s ``train()`` on smollm-135m at full
    width and depth (fp32, the CLI's defaults) with exact launches and a
    bit-equal resume, the loss falling on a repeated batch, a step at seq
    2,048, card-against-CPU steps (smollm at 2 layers, phi3.5-moe at 1,
    whisper-medium at 1 + 1), phi3.5-moe at one layer and whisper-medium
    at full depth."""
    import tempfile
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli
    from repro_torch.train.train_loop import (init_train_state, make_train_step,
                                              train)
    out = {"kernels": train_kernel_cases(device)}
    torch.cuda.empty_cache()
    scratch = ROOT / "_scratch"
    scratch.mkdir(exist_ok=True)

    # --- smollm-135m at full width and depth through the CLI's train() ---
    with tempfile.TemporaryDirectory(dir=scratch) as d1, \
            tempfile.TemporaryDirectory(dir=scratch) as d2:
        args = cli.parse_args(["--arch", "smollm-135m", "--steps", str(TRAIN_STEPS),
                               "--ckpt-dir", d1, "--ckpt-every",
                               str(TRAIN_CKPT_EVERY)])
        model, opt, data, loop = cli.build(args)
        cfg = model.cfg
        assert (cfg.n_layers, cfg.d_model, cfg.dtype, cfg.remat) == (
            30, 576, "float32", True)
        stamps = []
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state_a, losses_a = train(model, opt, data, loop, log=print,
                                  on_step=lambda s, m: stamps.append(
                                      time.perf_counter()))
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_train_launches(counts, smollm_train_launches(cfg.n_layers),
                             TRAIN_STEPS, "smollm-135m training")
        # step times, leaving out the steps after a checkpoint write
        steps = [b - a for i, (a, b) in enumerate(zip(stamps, stamps[1:]))
                 if (i + 1) % TRAIN_CKPT_EVERY]
        step_s = float(np.median(steps))
        run = {"pass": "smollm-135m train", "batch": args.batch, "seq": args.seq,
               "steps": TRAIN_STEPS, "launches": counts, "wall_s": wall,
               "step_ms_median": step_s * 1e3,
               "tokens_per_s": args.batch * args.seq / step_s,
               "losses": losses_a, "max_memory_allocated": peak}
        # interrupted at step 10, then resumed to 20 from the checkpoint
        ops.reset_launch_counts()
        loop_b = dataclasses.replace(loop, ckpt_dir=d2, total_steps=TRAIN_CKPT_EVERY)
        _, first = train(model, opt, data, loop_b, log=print)
        state_b, rest = train(model, opt, data,
                              dataclasses.replace(loop_b, total_steps=TRAIN_STEPS),
                              log=print)
        resumed = ops.launch_counts()
        check_train_launches(resumed, smollm_train_launches(cfg.n_layers),
                             TRAIN_STEPS, "smollm-135m resumed training")
        run["resume_losses_equal"] = first + rest == losses_a
        run["resume_params_equal"] = tree_equal(state_a["params"], state_b["params"])
        run["resume_opt_equal"] = tree_equal(state_a["opt"], state_b["opt"])
        run["resume_launches"] = resumed
        print(json.dumps({k: v for k, v in run.items() if k != "losses"}))
        print(json.dumps({"smollm_train_losses": losses_a}))
        if not (run["resume_losses_equal"] and run["resume_params_equal"]
                and run["resume_opt_equal"]):
            raise AssertionError(f"resumed training differs: {run}")
    del state_b
    out["smollm"] = run

    # --- the device-busy share of two steps, the loss falling on one batch ---
    step_fn = make_train_step(model, opt)
    batch = next(iter(TokenStream(data)))
    holder = {"state": state_a}

    def one_step():
        holder["state"], holder["m"] = step_fn(holder["state"], batch)

    one_step()
    out["smollm"]["profile"] = profiled_steps([one_step, one_step])
    print(json.dumps({"smollm_train_profile": out["smollm"]["profile"]}))
    del holder, state_a
    state = init_train_state(model, opt, seed=5)
    falling = []
    for _ in range(5):
        state, m = step_fn(state, batch)
        falling.append(float(m["loss"]))
    out["smollm"]["repeated_batch_losses"] = falling
    print(json.dumps({"smollm_repeated_batch_losses": falling}))
    if not falling[-1] < falling[0]:
        raise AssertionError(f"the loss did not fall on a repeated batch: {falling}")

    # --- one step at seq 2,048 ---
    long = dataclasses.replace(data, seq_len=2048)
    lbatch = next(iter(TokenStream(long)))
    state, _ = step_fn(state, lbatch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step_fn(state, lbatch)
    float(m["loss"])
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    out["smollm"]["seq2048"] = {"batch": long.global_batch, "seq": 2048,
                                "step_ms": long_s * 1e3,
                                "tokens_per_s": long.global_batch * 2048 / long_s,
                                "loss": float(m["loss"]),
                                "max_memory_allocated": torch.cuda.max_memory_allocated()}
    print(json.dumps({"smollm_seq2048_step": out["smollm"]["seq2048"]}))
    del state, model, step_fn
    torch.cuda.empty_cache()

    out["parity"] = [train_parity(device, *run) for run in PARITY_RUNS]
    out["moe"] = train_big(device, "phi3.5-moe-42b-a6.6b", n_layers=1)
    out["whisper"] = train_big(device, "whisper-medium")
    return out


# (arch, depth cut, batch, seq, steps, weight seed, data seed): smollm at 2
# layers; phi3.5-moe and whisper-medium at train_big's seeds and batch, so
# the card's first loss is that of phi3.5-moe's run at the same depth (one
# step: three took 155 s on an H100 with 8 host cores)
PARITY_RUNS = (("smollm-135m", dict(n_layers=2), 2, 64, 1, 3, 7),
               ("phi3.5-moe-42b-a6.6b", dict(n_layers=1), 8, 128, 1, 4, 2),
               ("whisper-medium", dict(n_layers=1, dec_layers=1), 2, 64, 3, 4, 2))


def step_grads(model, like, params: dict, batch: dict) -> tuple:
    """(loss, {name: gradient}) of ``model.loss`` at the flat ``params``
    (``like`` the tree they unflatten into)."""
    from repro_torch.utils import unflatten_like
    for t in params.values():
        t.requires_grad_(True)
    loss = model.loss(unflatten_like(like, iter(params.values())), batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for t in params.values():
        t.requires_grad_(False)
    return float(loss.detach()), grads


def train_parity(device, arch: str, replace: dict, batch: int, seq: int,
                 steps: int, seed: int, data_seed: int) -> dict:
    """``steps`` training steps of ``arch`` at full width, its depth cut
    by ``replace`` (fp32, remat), from the same seeded weights and batches
    on the card (kernels) and on the CPU (plain versions).  The first step
    is held: the loss (moe: its load-balancing loss included) within 1e-5
    relative, the grad norm within 1e-4 relative, every gradient within
    1e-4 of its largest |value|, every parameter the card's AdamW step
    writes within 1e-5 of its largest |value| of the same update computed
    on the CPU from the card's gradients, and of the CPU's whole step
    wherever the gradient is at least 1e-3 of the leaf's largest and,
    clipped, at least 1e3 eps.  Elsewhere the whole step is printed, not held: AdamW's first
    update is lr * g / (|g| + eps), so an element whose gradient is near
    eps = 1e-8 turns a gradient difference of ~1e-6 of the leaf's largest
    into a part of lr.  The later steps' losses on both sides are printed
    beside each other."""
    from repro_torch.data.pipeline import DataConfig, TokenStream, make_frames
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             init_opt_state)
    from repro_torch.utils import named_leaves
    cfg = get_config(arch).replace(dtype="float32", **replace)
    assert cfg.remat
    opt = OptimizerConfig(warmup_steps=1)
    stream = iter(TokenStream(DataConfig(cfg.vocab_size, seq, batch, seed=data_seed)))
    batches = [next(stream) for _ in range(steps)]
    if cfg.is_encdec:
        frames = make_frames(cfg.d_model, batch, WHISPER_FRAMES, seed=31)
        for b in batches:
            b["frames"] = frames
    cpu_model = get_model(cfg, device="cpu")
    like = cpu_model.init_params(seed)
    init = dict(named_leaves(like))
    runs = []
    for dev, model in ((device, get_model(cfg, device=device)), ("cpu", cpu_model)):
        params = {n: t.to(dev) for n, t in init.items()}
        loss, grads = step_grads(model, like, params, batches[0])
        new, state, m = adamw_update(params, grads, init_opt_state(params, opt), opt)
        if dev != "cpu":
            grads = {n: t.cpu() for n, t in grads.items()}
        first = (loss, float(m["grad_norm"]), grads, {n: t.cpu() for n, t in new.items()})
        losses = [loss]
        del params, grads, m
        for b in batches[1:]:
            loss, g = step_grads(model, like, new, b)
            new, state, _ = adamw_update(new, g, state, opt)
            losses.append(loss)
            del g
        runs.append(first + (losses,))
        del new, state
        torch.cuda.empty_cache()
    (lc, gc, dc, nc, losses_c), (lh, gh, dh, nh, losses_h) = runs
    del runs
    # the card's step against the CPU's from the card's gradients
    same, _, _ = adamw_update(init, dc, init_opt_state(init, opt), opt)
    step_err = {n: max_rel(nc[n], same[n]) for n in same}
    del same
    grad_err = {n: max_rel(dc[n], dh[n]) for n in dh}
    whole_err, held_err = {}, {}
    clip = min(1.0, opt.clip_norm / gh)
    for n in nh:
        diff, top = (nc[n] - nh[n]).abs(), nh[n].abs().max().clamp_min(1e-30)
        g = dh[n].abs()
        held = (g >= 1e-3 * g.max()) & (clip * g >= 1e3 * opt.eps)
        whole_err[n] = float(diff.max() / top)
        held_err[n] = float(diff[held].max() / top) if held.any() else 0.0
    n_w = max(whole_err, key=whole_err.get)
    i = int((nc[n_w] - nh[n_w]).abs().argmax())
    row = {"arch": arch, "reduced": replace, "batch": batch, "seq": seq,
           "loss_card": lc, "loss_cpu": lh, "loss_rel": abs(lc - lh) / abs(lh),
           "grad_norm_card": gc, "grad_norm_cpu": gh,
           "grad_norm_rel": abs(gc - gh) / abs(gh),
           "grad_err_of_largest": max(grad_err.values()),
           "step_err_of_largest": max(step_err.values()),
           "whole_step_param_err_of_largest": whole_err[n_w],
           "whole_step_held_param_err_of_largest": max(held_err.values()),
           "whole_step_worst": {"param": n_w, "grad_card": float(dc[n_w].flatten()[i]),
                                "grad_cpu": float(dh[n_w].flatten()[i])},
           "losses_card": losses_c, "losses_cpu": losses_h,
           "losses_rel": [abs(a - b) / abs(b) for a, b in zip(losses_c, losses_h)]}
    print(json.dumps({"train_parity": row}))
    if not (row["loss_rel"] <= 1e-5 and row["grad_norm_rel"] <= 1e-4
            and row["grad_err_of_largest"] <= 1e-4
            and row["step_err_of_largest"] <= 1e-5
            and row["whole_step_held_param_err_of_largest"] <= 1e-5):
        raise AssertionError(f"{arch} training step: card and CPU differ: {row}")
    return row


def train_big(device, arch: str, steps: int = 3, **replace) -> dict:
    """``steps`` training steps of ``arch`` at full width in fp32 (the
    depth cut by ``replace``): phi3.5-moe at the CLI's batch (8 x 128)
    with its load-balancing loss finite and nonzero; whisper-medium at 2
    x (1,500 frames, 64 decoder tokens).  Exact backward launches."""
    from repro_torch.data.pipeline import DataConfig, TokenStream, make_frames
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_config
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, params, info = big_model(arch, device, seed=4, dtype="float32",
                                    **replace)
    cfg = model.cfg
    if replace:
        full = get_config(arch)
        info["reduced"] = {k: f"{v} of {getattr(full, k)}"
                           for k, v in replace.items()}
        print(json.dumps({"reduced": info["reduced"], "arch": arch,
                          "why": "fp32 parameters, gradients and both moments "
                                 "of every layer do not fit one card"}))
    opt = OptimizerConfig(warmup_steps=1)
    state = {"params": params, "opt": init_opt_state(params, opt)}
    del params
    if cfg.is_encdec:
        B, seq = 2, 64
        frames = make_frames(cfg.d_model, B, WHISPER_FRAMES, seed=31)
    else:
        B, seq = 8, 128
    stream = iter(TokenStream(DataConfig(cfg.vocab_size, seq, B, seed=2)))
    step_fn = make_train_step(model, opt)
    ops.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        batch = next(stream)
        if cfg.is_encdec:
            batch["frames"] = frames
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    if cfg.is_encdec:       # encoder 24 + decoder 2 x 24 (self, cross), remat x2
        L, Ld = cfg.n_layers, cfg.dec_layers
        want = {"flash_attention": L + 4 * Ld, "flash_attention_bwd": L + 2 * Ld}
    else:
        want = smollm_train_launches(cfg.n_layers)
    check_train_launches(counts, want, steps, f"{arch} training")
    row = {"arch": arch, "model": info, "batch": B, "seq": seq, "steps": steps,
           "losses": losses, "step_ms": [t * 1e3 for t in times],
           "tokens_per_s": B * seq / float(np.median(times[1:])),
           "launches": counts, "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if cfg.n_experts:
        with torch.no_grad():
            _, aux = model.forward(state["params"], batch)
        row["aux_loss"] = float(aux)
        if not (np.isfinite(row["aux_loss"]) and row["aux_loss"] > 0):
            raise AssertionError(f"{arch}: load-balancing loss {row['aux_loss']}")
    print(json.dumps(row))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch}: losses {losses}")
    del state, model
    torch.cuda.empty_cache()
    return row


def kernel_summary(kernels: list, serve: list, engine: list,
                   tidal_row: dict, tenants: dict, ssm: dict,
                   big: tuple = (), xlstm: dict | None = None,
                   whisper: dict | None = None, train: dict | None = None) -> list:
    """One entry per kernel (and the int8 variant) at the main path's
    shapes, with its launches from the serving phases (3, 5, 6, 7 and 8,
    the serving, engine and FaaS passes of ``big``: phases 9, 10 and 11,
    those of ``xlstm``: phase 12, and ``whisper``'s Engine: phase 13) and
    the training runs of phase 14 (``train``; the backward kernels run
    there only)."""
    def pick(**kw):
        return next(r for r in kernels if all(r.get(k) == v for k, v in kw.items()))

    launches = {"paged": 0, "int8": 0, "flash": 0, "decode": 0, "rmsnorm": 0,
                "rmsnorm_fused": 0, "ssd": 0, "flash_bwd": 0, "rmsnorm_bwd": 0}
    cp = tenants["control_plane"]
    rows = (list(serve) + list(engine) + [tidal_row, tenants,
                                          cp["learned_prefix"], cp["open_loop"]]
            + [ssm["serve"], ssm["engine"], ssm["engine_prompts_continuous"],
               ssm["faas"]])
    for phase in big:
        rows += list(phase["serve"]) + [phase["engine"],
                                        phase["engine"]["continuous"],
                                        phase["faas"]] + (
            [phase["faas_lora"]] if "faas_lora" in phase else [])
    if xlstm is not None:
        rows += [xlstm["serve"], xlstm["engine"],
                 xlstm["engine_prompts_continuous"], xlstm["faas"]]
    if whisper is not None:
        rows.append(whisper["engine"])
    if train is not None:
        rows += [train["smollm"], {"launches": train["smollm"]["resume_launches"]},
                 train["moe"], train["whisper"]]
    for row in rows:
        key = "int8" if row.get("pass") == "int8" else "paged"
        launches[key] += row["launches"]["paged_decode_attention"]
        launches["flash"] += row["launches"]["flash_attention"]
        launches["decode"] += row["launches"]["decode_attention"]
        launches["rmsnorm"] += row["launches"]["rmsnorm"]
        launches["rmsnorm_fused"] += row["launches"]["rmsnorm_fused"]
        launches["ssd"] += row["launches"]["ssd_scan"]
        launches["flash_bwd"] += row["launches"].get("flash_attention_bwd", 0)
        launches["rmsnorm_bwd"] += row["launches"].get("rmsnorm_bwd", 0)
    entries = [
        ("paged_decode_attention",
         pick(kernel="paged_decode_attention", case="serving", shape="smollm",
              B=8, q_dtype="bfloat16", kv_dtype="bfloat16"),
         "src/repro_torch/csrc/paged_decode_attention.cu",
         "src/repro/kernels/paged_decode_attention.py:129", launches["paged"]),
        ("paged_decode_attention[int8]",
         pick(kernel="paged_decode_attention", case="serving", shape="smollm",
              B=8, q_dtype="bfloat16", kv_dtype="int8"),
         "src/repro_torch/csrc/paged_decode_attention.cu",
         "src/repro/kernels/paged_decode_attention.py:129", launches["int8"]),
        ("flash_attention",
         pick(kernel="flash_attention", shape="smollm", S=384, T=384,
              dtype="bfloat16"),
         "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:86", launches["flash"]),
        ("decode_attention",
         pick(kernel="decode_attention", case="serving", shape="smollm",
              dtype="bfloat16"),
         "src/repro_torch/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention.py:76", launches["decode"]),
        ("rmsnorm",
         pick(kernel="rmsnorm", shape="smollm-decode", dtype="bfloat16"),
         "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm.py:25", launches["rmsnorm"]),
        # the residual form: a subset of the rmsnorm launches above
        ("rmsnorm[residual]",
         pick(kernel="rmsnorm[residual]", shape="smollm-decode", dtype="bfloat16"),
         "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm.py:25", launches["rmsnorm_fused"]),
        ("ssd_scan",
         pick(kernel="ssd_scan", B=1, S=200, bc_dtype="bfloat16"),
         "src/repro_torch/csrc/ssd_scan.cu",
         "src/repro/kernels/ssd_scan.py:79", launches["ssd"]),
    ]
    if train is not None:
        entries += [
            ("flash_attention_bwd",
             pick(kernel="flash_attention_bwd", shape="smollm", S=128, T=128),
             "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:86", launches["flash_bwd"]),
            ("rmsnorm_bwd",
             pick(kernel="rmsnorm_bwd", shape="smollm-train"),
             "src/repro_torch/csrc/rmsnorm_bwd.cu",
             "src/repro/kernels/rmsnorm.py:25", launches["rmsnorm_bwd"]),
        ]
    out = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
           for name, r, src, rep, n in entries]
    if not all(e["launches"] > 0 for e in out):
        raise AssertionError(f"a kernel never ran on the main path: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT,
                    help="directory for chip_smoke.json")
    ap.add_argument("--first-ttft", choices=["prewarm", "no-prewarm"],
                    help=argparse.SUPPRESS)    # phase 6's fresh-process probe
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    _import_port()
    if args.first_ttft:
        print(json.dumps(first_ttft(args.first_ttft)))
        return 0
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phases = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        release_host_memory()
        torch.cuda.empty_cache()
        phases[name] = time.perf_counter() - t
        mem = meminfo()
        print(f"phase {name}: {phases[name]:.1f} s (host memory "
              f"{mem['host_available_gb']:.1f} of {mem['host_total_gb']:.1f} GB "
              f"available)")
        return out

    def ssm_phase(h2d):
        rows = phase_ssm_kernels(device)
        return rows, phase_zamba(device, h2d)

    dev = timed("device", phase_device)
    h2d = dev["h2d_bytes_per_s"]
    kernels = timed("kernels", phase_kernels, device)
    model, params = full_model(device)
    serve, paged_tokens = timed("serve", phase_serve, model, params)
    parity = timed("parity", phase_parity, device)
    engine = timed("engine", phase_engine, model, params, paged_tokens)
    del model, params
    tidal_row = timed("tidal", phase_tidal, device, dev["h2d_bytes_per_s"])
    tenants = timed("tenants", phase_tenants, device, dev["h2d_bytes_per_s"])
    torch.cuda.empty_cache()
    ssm_rows, ssm = timed("ssm", ssm_phase, dev["h2d_bytes_per_s"])
    kernels += ssm_rows
    llama = timed("llama", phase_llama, device, h2d)
    moe = timed("moe", phase_moe, device, h2d)
    deepseek = timed("deepseek", phase_deepseek, device, h2d)
    xlstm = timed("xlstm", phase_xlstm, device, h2d)
    kernels += xlstm["kernels"]
    whisper = timed("whisper", phase_whisper, device)
    kernels += whisper["kernels"]
    train = timed("train", phase_train, device)
    kernels += train["kernels"]
    summary = kernel_summary(kernels, serve, engine, tidal_row, tenants, ssm,
                             (llama, moe, deepseek), xlstm, whisper, train)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "chip_smoke.json").write_text(json.dumps(
        {"device": dev, "kernels": kernels, "serve": serve, "parity": parity,
         "engine": engine, "tidal": tidal_row, "tenants": tenants, "ssm": ssm,
         "llama": llama, "moe": moe, "deepseek": deepseek, "xlstm": xlstm,
         "whisper": whisper, "train": train, "summary": summary,
         "phases_s": phases,
         "seconds": time.perf_counter() - t0}, indent=1))
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
