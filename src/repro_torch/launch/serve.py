"""Serving driver: deploy LLM functions on the port's TIDAL stack and
serve a closed loop of requests through ``FaaSRuntime`` (on the card by
default; ``--device cpu`` with a reduced depth runs it on the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch smollm-135m --functions 3 --requests 12 --lora
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-13b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3.5-moe-42b-a6.6b --layers 8
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v3-671b --layers 1

Per request the runtime picks the service class itself: ``cold`` (first
invocation), ``fork`` (adaptive state forking from the template, prefill
overlapped with weight streaming) or ``warm`` (a kept-alive engine, no
forking).  Every TTFT feeds back into the template's Eq. 1 residency.

Weights are random from a seed.  On the card the model is the full-width
configuration of ``--arch``; on the CPU it is the narrow smoke
configuration, as ``repro.launch.serve`` serves it there.  ``--layers``
cuts the depth of either.  zamba2-2.7b (Mamba2 + shared attention) serves
over the dense slot pool, its prefills through the ``ssd_scan`` kernel;
xlstm-1.3b (mLSTM and sLSTM blocks; ``--layers`` a multiple of its
``slstm_every``) over the dense slot pool too, its prompts at most its
chunk (128 tokens) or a multiple of it, as in the reference.
phi3.5-moe-42b-a6.6b (84 GB in bf16) fits one card only with ``--layers``
cut (8 of 32 leave room for a fork's copy), deepseek-v3-671b (MLA over a
latent paged arena, 256 experts and a shared one; 23 GB per layer) with
``--layers 1``: a model whose weights take more than half the card exits
asking for ``--layers``.  ``--lora`` targets the GQA query projection,
which MLA and xLSTM do not have, so deepseek-v3 and xlstm-1.3b serve
static functions only.
llama2-70b (140 GB) needs ``--tp 4`` over four cards.
whisper-medium (enc-dec) exits: as in the reference, it generates through
the sequential ``Engine`` only (``Engine.generate(frames=)``).

``--open-loop --qps Q [--deadline D]`` replaces the closed loop (submit,
wait, repeat) with open-loop Poisson arrivals through the async gateway:
requests are ticketed at their scheduled arrivals however far behind the
engines are, and requests still queued past ``D`` seconds are shed.
``--predictive`` attaches the control plane (forecast-driven pre-forks
and keep-alive, runtime-learned prefix bakes within ``--prefix-budget``
bytes).

``--tp N`` serves one tensor-parallel instance of N ranks, one process
each (``repro_torch.distributed.spawn``; ``--backend``, default gloo,
which also lets ranks share one card: NCCL refuses two ranks on one
device).  Every rank draws its shard of the weights from the seed; rank
0 runs the runtime and prints, the others serve its device ops.  The
dense and moe families (GQA or MLA attention): a moe rank holds E / N
whole experts, an MLA rank H / N heads and the whole latent arena, so
``--arch phi3.5-moe-42b-a6.6b --tp 2 --layers 4`` and ``--arch
deepseek-v3-671b --tp 2 --layers 1`` serve on one card; ``--lora
--tp N`` merges each rank's shard of the adapter's delta into its shard
of the query projection.  zamba2-2.7b and xlstm-1.3b serve at ``--tp
N`` too (a rank holds its Mamba2, attention, mLSTM and sLSTM heads; the
norms over a split row run the split-row rmsnorm), ``--lora`` on zamba
merging into its shared block's query projection.  Heads the model
axis does not divide split unevenly (``sharding.head_split``: ``--arch
smollm-135m --tp 2`` serves 6 query / 2 KV heads on rank 0 and 3 / 1 on
rank 1).  whisper-medium exits under ``--tp`` as without it (it serves
under a plan through ``Model.prefill`` and ``decode_step``).

``--instances K`` serves K instances (``ServingMesh(K, 1)``), instance i
on ``cuda:(i mod device_count)`` (K instances share one card), each with
its own KV pools and warm engines; new engines go where the function is
already warm unless that instance is busier (locality routing).  With
``--tp N`` each instance is a rank group of N ranks (``ServingMesh(K,
N)``, K N rank processes; on one card all of them share it over gloo).

    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 --device cpu \
        --arch deepseek-v3-671b --layers 2
    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 --device cpu \
        --arch zamba2-2.7b --lora
    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 --device cpu \
        --arch xlstm-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve --instances 2 \
        --device cpu --layers 2
    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 --lora \
        --device cpu --layers 2
    PYTHONPATH=src python -m repro_torch.launch.serve --instances 2 \
        --tp 2 --device cpu --layers 2
"""

from __future__ import annotations

import argparse
import collections
import sys

import numpy as np
import torch

from repro_torch.core import api as tidal
from repro_torch.data.pipeline import make_prompts
from repro_torch.distributed import ServingMesh, sharding, spawn
from repro_torch.models import transformer
from repro_torch.models.registry import ARCH_IDS, get_config, get_model
from repro_torch.models.config import reduced
from repro_torch.runtime.controlplane import ControlPlane
from repro_torch.runtime.errors import DeadlineExceeded
from repro_torch.runtime.faas import FaaSRuntime
from repro_torch.runtime.gateway import InvocationRequest
from repro_torch.utils import fmt_bytes, tree_bytes

# the projection --lora adapts: the attention query weights of every
# layer (dense, moe) or of zamba's one shared attention block; xlstm has
# no attention, and the reference's --lora cannot target it either
LORA_TARGET = {"dense": "blocks.attn.wq", "moe": "blocks.attn.wq",
               "zamba": "shared_attn.attn.wq"}


def _serve_open_loop(rt: FaaSRuntime, cfg, args, rng) -> None:
    """Open-loop Poisson arrivals through the async gateway."""
    schedule, t = [], 0.0
    for r in range(args.requests):
        t += rng.exponential(1.0 / args.qps)
        name = f"fn-{rng.integers(args.functions)}"
        event = ({"adapter": f"adapter-{rng.integers(3)}"}
                 if args.lora else {})
        prompt = make_prompts(cfg.vocab_size, 1, args.prompt_len,
                              seed=100 + r)[0]
        schedule.append((t, InvocationRequest(
            name, prompt, event=event, max_new_tokens=args.max_new,
            deadline_s=args.deadline)))
    handles = rt.gateway.replay(schedule)

    ttfts, kinds = [], collections.Counter()
    for r, h in enumerate(handles):
        try:
            res = h.result()
        except DeadlineExceeded:
            kinds["shed"] += 1
            print(f"req{r:02d} {h.request.fn_name} SHED "
                  f"(deadline {args.deadline}s)")
            continue
        ttfts.append(res.ttft_s)
        kinds[res.kind] += 1
        print(f"req{r:02d} {res.fn_name} {res.kind:4s} "
              f"ttft={res.ttft_s*1e3:7.1f}ms e2e={res.e2e_s*1e3:7.1f}ms "
              f"tokens={[int(tk) for tk in res.tokens[:4]]}...")
    if ttfts:
        print(f"\nopen-loop @ {args.qps} qps: "
              f"p50 ttft {np.percentile(ttfts, 50)*1e3:.1f}ms  "
              f"p95 {np.percentile(ttfts, 95)*1e3:.1f}ms  "
              f"kinds={dict(kinds)}")
    if rt.control_plane is not None:
        cp = rt.control_plane
        print(f"control plane: {cp.stats}  "
              f"pinned={fmt_bytes(cp.pinned_nbytes())}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--functions", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="KV-cache slots per engine (decode batch capacity)")
    ap.add_argument("--keep-alive", type=float, default=60.0)
    ap.add_argument("--lora", action="store_true",
                    help="deploy dynamic (LoRA) function variants")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the full configuration)")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="chunked prefill: split prompts into page-multiple "
                         "chunks interleaved with decode")
    ap.add_argument("--kv-dtype", choices=["int8"], default=None,
                    help="quantize the paged KV arena (int8 values and "
                         "per-row scales, dequantized inside the decode "
                         "kernel)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="queueing deadline (s); expired requests shed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--open-loop", action="store_true",
                    help="Poisson arrivals through the async gateway "
                         "instead of the closed submit-wait loop")
    ap.add_argument("--qps", type=float, default=4.0,
                    help="open-loop arrival rate (requests/s)")
    ap.add_argument("--predictive", action="store_true",
                    help="attach the prewarm control plane: forecast "
                         "arrivals to pre-fork engines and adapt "
                         "keep-alive, and bake runtime-observed hot "
                         "prompt prefixes under a pinned-bytes budget")
    ap.add_argument("--prewarm-horizon", type=float, default=0.25,
                    help="forecast horizon (s) for predictive pre-forking")
    ap.add_argument("--prefix-budget", type=int, default=1 << 22,
                    help="pinned-bytes budget for runtime-learned prefix KV")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks of the one instance")
    ap.add_argument("--backend", default="gloo",
                    help="the ranks' torch.distributed backend (gloo or nccl)")
    ap.add_argument("--instances", type=int, default=1,
                    help="serving instances (a mesh's data axis), with "
                         "locality routing")
    args = ap.parse_args(argv)
    cfg = _config(args)
    if args.device != "cpu" and args.layers is None:
        # every rank's weights and a fork's copy, on the cards they share
        weights = tree_bytes(transformer.param_specs(
            sharding.local_config(cfg, args.tp, 0)))
        sharing = -(-args.tp * args.instances // torch.cuda.device_count())
        card = torch.cuda.get_device_properties(0).total_memory
        if 2 * weights * sharing > card:
            sys.exit(f"--arch {args.arch}: {fmt_bytes(weights)} of weights "
                     f"per rank, {sharing} rank(s) per card, and a fork's "
                     f"copy do not fit the card's {fmt_bytes(card)}; cut the "
                     "depth with --layers")
    if args.tp > 1:
        sharding.check_tp(cfg, args.tp)
        spawn(_serve_rank, args.tp, (args,), data=args.instances,
              backend=args.backend, device=args.device)
    else:
        serve(args)


def _serve_rank(group, args) -> None:
    serve(args, group)


def _config(args):
    """The served configuration: the full width of ``--arch`` on the card,
    its smoke configuration on the CPU, ``--layers`` deep."""
    cfg = get_config(args.arch)
    if cfg.is_encdec:
        sys.exit(f"--arch {args.arch}: enc-dec serves through the sequential "
                 "Engine (Engine.generate(frames=...)), not through "
                 "FaaSRuntime's continuous engines")
    if args.lora and cfg.use_mla:
        sys.exit(f"--lora: {cfg.name} has MLA attention; the adapters target "
                 f"{LORA_TARGET[cfg.family]}, a GQA projection it does not have")
    if args.lora and cfg.family not in LORA_TARGET:
        sys.exit(f"--lora: {cfg.name} has no attention; the adapters target "
                 "the GQA query projection blocks.attn.wq, which it does not "
                 "have")
    extra = {} if args.layers is None else {"n_layers": args.layers}
    return reduced(cfg, **extra) if args.device == "cpu" else cfg.replace(**extra)


def serve(args, group=None) -> None:
    """Deploy and serve (on the controller rank of ``group`` when given;
    its workers serve the controller's device ops)."""
    cfg = _config(args)
    device = args.device if group is None else group.device
    model = get_model(cfg, device=device,
                      plan=None if group is None else group.plan)
    fns = []
    for i in range(args.functions):
        params = model.init_params(seed=args.seed + i)
        name = f"fn-{i}"
        if args.lora:
            fns.append(tidal.lora_function(name, model, params,
                                           [LORA_TARGET[cfg.family]],
                                           n_adapters=3))
        else:
            fns.append(tidal.static_function(name, model, params))
        del params
    if group is not None:
        fns = [group.bind(fn) for fn in fns]
        if not group.is_controller:
            group.serve()
            return
        local = model.local_cfg
        if cfg.family == "xlstm":
            mlp = "split" if local.slstm_mlp_split else "whole"
            heads = (f"{local.n_heads} mLSTM / sLSTM heads (sLSTM post-MLP "
                     f"{mlp})")
        else:
            heads = (f"{local.n_heads} MLA heads" if cfg.use_mla else
                     f"{local.n_heads} query / {local.n_kv_heads} KV heads")
        per = " per rank"
        split = None if cfg.use_mla else sharding.head_split(cfg, group.size)
        if split is not None and not split.even:
            per = " on rank 0 (split unevenly: " + ", ".join(
                f"{b - a}/{d - c}" for (a, b), (c, d) in zip(split.q, split.kv)
            ) + ")"
        if cfg.family == "zamba":
            heads += f", {local.ssm_heads} Mamba2 heads"
        first, end = local.expert_range
        experts = f", {end - first} experts" if cfg.n_experts else ""
        print(f"tensor parallel: {group.size} ranks ({group.backend}), "
              f"{heads}{experts}{per}")
        if group.n_instances > 1:
            ranks = [list(range(i * group.size, (i + 1) * group.size))
                     for i in range(group.n_instances)]
            print(f"instances: {group.n_instances} rank groups, ranks "
                  f"{ranks} ({group.backend})")
    mesh = group.mesh if group is not None else ServingMesh(args.instances, 1)
    rt = FaaSRuntime(n_slots=args.slots,
                     max_len=args.prompt_len + args.max_new,
                     keep_alive_s=args.keep_alive, trace_seq=args.prompt_len,
                     chunk_tokens=args.chunk_tokens, kv_dtype=args.kv_dtype,
                     mesh=mesh, device=device)
    if len(rt.instances) > 1 and group is None:
        print(f"instances: {len(rt.instances)} on "
              f"{[str(inst.device) for inst in rt.instances]}")
    if args.predictive:
        ControlPlane(rt, pinned_bytes_budget=args.prefix_budget,
                     prewarm_horizon_s=args.prewarm_horizon)
        print(f"control plane attached: prewarm horizon "
              f"{args.prewarm_horizon}s, prefix budget "
              f"{fmt_bytes(args.prefix_budget)}")

    rng = np.random.default_rng(args.seed)
    for fn in fns:
        rt.deploy(fn, {"adapter": "adapter-0"} if args.lora else {},
                  prewarm_seq=args.prompt_len)
    print(f"deployed {args.functions} function(s) of {cfg.name} "
          f"({cfg.n_layers} layers, {cfg.dtype}) on {rt.device}; warmed "
          f"{rt.exe_cache.stats.misses} entry points in "
          f"{rt.exe_cache.stats.compile_s:.1f}s")

    if args.open_loop:
        _serve_open_loop(rt, cfg, args, rng)
        return

    ttfts, kinds = [], collections.Counter()
    for r in range(args.requests):
        name = f"fn-{rng.integers(args.functions)}"
        event = ({"adapter": f"adapter-{rng.integers(3)}"}
                 if args.lora else {})
        prompt = make_prompts(cfg.vocab_size, 1, args.prompt_len,
                              seed=100 + r)[0]
        try:
            res = rt.submit(InvocationRequest(
                name, prompt, event=event, max_new_tokens=args.max_new,
                deadline_s=args.deadline)).result()
        except DeadlineExceeded:
            kinds["shed"] += 1
            print(f"req{r:02d} {name} SHED (deadline {args.deadline}s)")
            continue
        ttfts.append(res.ttft_s)
        kinds[res.kind] += 1
        fs = res.fork_stats
        detail = (f"reused={fmt_bytes(fs.reused_bytes):>10} "
                  f"streamed={fmt_bytes(fs.streamed_bytes):>10} "
                  f"dyn={fmt_bytes(fs.dynamic_bytes):>9}"
                  if fs is not None else " " * 43)
        print(f"req{r:02d} {name} "
              f"{'(' + event.get('adapter', '') + ')' if args.lora else '':14s}"
              f" {res.kind:4s} ttft={res.ttft_s*1e3:7.1f}ms "
              f"e2e={res.e2e_s*1e3:7.1f}ms {detail} "
              f"tokens={[int(t) for t in res.tokens[:4]]}...")

    if len(rt.instances) > 1:
        placed = collections.Counter(w.instance for w in rt._engines.values())
        print(f"warm engines per instance: "
              f"{[placed[inst.idx] for inst in rt.instances]}")
    p50, p95 = (np.percentile(ttfts, q) * 1e3 if ttfts else float("nan")
                for q in (50, 95))
    print(f"\np50 ttft {p50:.1f}ms  p95 {p95:.1f}ms  kinds={dict(kinds)}  "
          f"(Eq.1-adapted residency: "
          f"{[fmt_bytes(t.resident_bytes) for t in rt.server.templates.values()]})")


if __name__ == "__main__":
    main()
