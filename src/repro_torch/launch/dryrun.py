"""The dry run: one rank of every (architecture x input shape) cell on
the production mesh, reckoned on ``meta`` or run on the card (the port's
counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 placeholder host
devices and reads XLA's memory and cost analyses and the partitioned
HLO's collectives.  The port runs ONE rank of the mesh in one process
under torch's ``fake`` process group (``distributed.dry``): the rank's
plan, parameters, optimizer state, cache and inputs at their full
per-rank sizes, and one step (a train step, a prefill or a decode step)
through the port's own entry points.  For each cell it writes a JSON
artifact under ``artifacts/dryrun_torch/`` with the reference's keys:

  * ``meta``: the cell, the mesh (all three axes; the pod axis is folded
    into data for placement, ``launch.mesh``), the FSDP and factored
    decisions, ``param_bytes``, ``state_bytes_per_device`` (from the
    specs, the reference's ``_per_device_bytes``), the overrides;
  * ``memory``: the ``meta`` trace's reckoning (``distributed.dry.
    LiveBytes``): the arguments' bytes, the peak above them (XLA's temp
    size) and the outputs' bytes;
  * ``analytic``, ``model_flops_global`` and ``roofline`` (``H100_SXM``
    data-sheet rates: a bound, not a measurement);
  * ``collectives``: the step's collectives by kind and bytes, from the
    port's record (``launch.roofline.collective_bytes``);
  * ``card_lacks``: the backward kernels a bf16 train step needs that
    the card refuses (the ``meta`` trace goes past them by shapes);
  * with ``--device cuda`` also ``card``: the same step run once more on
    the card after a warm-up, its device milliseconds, its peak bytes
    above the arguments (``torch.cuda.max_memory_allocated``) and its
    collectives (the fake group moves no data: the values are not
    checked).

A cell the port cannot place or run writes ``{"refused": "<the port's
message>"}`` beside ``meta``; ``--all`` counts those apart from failures.

Usage:
  python -m repro_torch.launch.dryrun --all --device meta
  python -m repro_torch.launch.dryrun --arch chameleon-34b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch zamba2-2.7b --shape train_4k \\
      --multi-pod --device meta

``--all`` covers both meshes (``--multi-pod``: the multi-pod one only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Optional

import torch

from repro_torch.distributed import dry, fsdp, sharding
from repro_torch.distributed.sharding import DATA, MODEL
from repro_torch.kernels import grad
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import encdec, transformer
from repro_torch.models.registry import SHAPES, Model, cells, get_config
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step
from repro_torch.utils import fmt_bytes, map_with_path, named_leaves

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

# Big models need ZeRO-3 param sharding over the data axes; threshold is
# bytes-per-model-shard that still fits comfortably next to activations.
FSDP_THRESHOLD = 2 << 30
# Factored second moment for very large models (deepseek-v3).
FACTORED_THRESHOLD = 100e9

# the reference's overrides the port honours, and the GSPMD hints it
# refuses (the port places by role with explicit collectives)
HONOURED = ("fsdp", "remat", "cache_prefer_seq", "param_mode",
            "cache_replicate_model", "fused_glu", "fused_qkv")
GSPMD_HINTS = ("moe_shard_constraints", "attn_seq_shard_constraint",
               "attn_sp_prefill")


class Refused(Exception):
    """A cell the port cannot place or run, with the port's message."""


@dataclasses.dataclass
class Cell:
    """One rank of a cell: its model, its step and what the artifact
    records before the step runs."""
    model: Model
    meta: dict
    make_args: Callable[[Any], tuple]     # device -> the step's arguments
    step: Callable[..., Any]


def _check_overrides(overrides: dict) -> None:
    for key in overrides:
        if key in GSPMD_HINTS:
            raise Refused(f"override {key!r}: a GSPMD sharding-constraint "
                          "hint; the port places every leaf by its role and "
                          "runs explicit collectives")
        if key == "seq_parallel":
            raise Refused("override 'seq_parallel': a sequence-parallel "
                          "batch needs attention across sequence shards: "
                          "ROADMAP Queue 1, item 10")
        if key not in HONOURED:
            raise Refused(f"override {key!r}: not a knob of the reference's "
                          "dry run")


def spec_bytes(shape_tree, spec_tree, mesh) -> int:
    """Bytes per device of ``shape_tree`` placed by ``spec_tree`` over
    ``mesh`` ((data, model); the reference's ``_per_device_bytes``): each
    leaf's bytes divided by the axes its spec names, a 'model' dimension
    cut in ``parts`` by the piece a rank holds."""
    specs = dict(named_leaves(spec_tree))
    total = 0
    for path, leaf in named_leaves(shape_tree):
        spec = specs[path]
        n = leaf.numel() * leaf.element_size()
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            if entry == DATA:
                n //= mesh.shape[DATA]
            elif entry == (DATA, MODEL):
                n //= mesh.shape[DATA] * mesh.shape[MODEL]
            elif spec.parts:
                size = leaf.shape[d]
                n = n * sharding.piece_size(spec, size, mesh.shape[MODEL],
                                            0) // size
            else:
                n //= mesh.shape[MODEL]
        total += n
    return total


def _rank_leaves(model: Model, full: dict) -> dict:
    """The rank's pieces of a full ``meta`` parameter tree."""
    plan = model.plan
    if plan is None:
        return full
    specs = sharding.leaf_param_specs(model, plan.mesh)
    return map_with_path(lambda path, t: plan.shard(t, specs[path]), full)


def _params(model: Model, full_meta: dict, device, seed: int = 0) -> dict:
    if torch.device(device).type == "meta":
        return _rank_leaves(model, full_meta)
    return model.init_params(seed, draw_on_device=True)


def _family(cfg):
    return encdec if cfg.is_encdec else transformer


def cell_meta(arch: str, shape_name: str, mesh: Mesh,
              overrides: Optional[dict] = None) -> tuple:
    """``(cfg, meta, full)`` of a cell from its specs alone (no process
    group, no model): the bf16 configuration, the artifact's ``meta`` with
    the reference's decisions (train: FSDP above ``FSDP_THRESHOLD`` per
    model shard, a bf16 optimizer state factored above
    ``FACTORED_THRESHOLD``; decode: the flash-decoding cache split by
    sequence and no FSDP) and ``state_bytes_per_device`` (the parameters,
    and the optimizer state or the cache, by the port's specs), and the
    full parameter tree on ``meta``.  Raises :class:`Refused` with the
    port's message where its specs cannot place the cell."""
    overrides = dict(overrides or {})
    _check_overrides(overrides)
    cfg = get_config(arch)
    cfg_over = {k: overrides[k] for k in ("remat", "fused_glu", "fused_qkv")
                if k in overrides}
    cfg = dataclasses.replace(cfg, dtype="bfloat16", **cfg_over)
    sh = SHAPES[shape_name]
    mode, seq, batch = sh["mode"], sh["seq"], sh["batch"]
    place = mesh.placement()
    D, M = place.data, place.model
    full = _family(cfg).param_specs(cfg)
    pbytes = sum(t.numel() * t.element_size() for _, t in named_leaves(full))
    fsdp_on = overrides.get("fsdp", pbytes / M > FSDP_THRESHOLD)
    param_mode = overrides.get("param_mode", "tp")
    decode = mode == "decode"
    if decode and "fsdp" not in overrides:
        fsdp_on = False                     # the reference's decode default
    meta = {"arch": arch, "shape": shape_name, "mode": mode, "seq": seq,
            "batch": batch, "fsdp": fsdp_on, "param_bytes": pbytes,
            "overrides": overrides, "mesh": dict(mesh.axes),
            "placement": {"data": D, "model": M}, "param_mode": param_mode}
    try:
        meta["rank_heads"] = _rank_heads(cfg, M if param_mode == "tp" else 1)
        p_specs = sharding.config_param_specs(cfg, M, fsdp=fsdp_on,
                                              mode=param_mode, data=D)
        meta["param_bytes_per_device"] = spec_bytes(full, p_specs, place)
        if mode == "train":
            factored = pbytes > FACTORED_THRESHOLD
            opt_cfg = OptimizerConfig(state_dtype="bfloat16", factored=factored)
            meta["optimizer"] = {"state_dtype": "bfloat16",
                                 "factored": factored}
            opt = init_opt_state(full, opt_cfg)
            o_specs = sharding.opt_state_specs(p_specs, place, opt_state=opt)
            meta["state_bytes_per_device"] = (meta["param_bytes_per_device"]
                                              + spec_bytes(opt, o_specs, place))
            return cfg, meta, full
        prefer_seq = overrides.get("cache_prefer_seq", decode)
        gmodel = Model(cfg, "meta")
        gcache = gmodel.make_cache(batch, seq, device="meta")
        c_specs = sharding.cache_specs(
            gmodel, gcache, place, batch, prefer_seq=prefer_seq,
            replicate_model=overrides.get("cache_replicate_model", False))
        meta["cache_prefer_seq"] = prefer_seq
        meta["rank_batch"] = _rows(batch, D)
        meta["state_bytes_per_device"] = (meta["param_bytes_per_device"]
                                          + spec_bytes(gcache, c_specs, place))
        return cfg, meta, full
    except (NotImplementedError, ValueError) as e:
        raise Refused(f"{type(e).__name__}: {e}") from e


def _rank_heads(cfg, tp: int) -> dict:
    """The reckoned rank's (global rank 0's) query and KV heads, the most
    any rank holds, and whether the model axis divides the heads (else
    they split unevenly, ``sharding.head_split``)."""
    sharding.check_tp(cfg, tp)
    if cfg.use_mla or tp == 1:
        return {"query": cfg.n_heads // tp, "kv": cfg.n_kv_heads,
                "most_query": cfg.n_heads // tp, "even": True}
    split = sharding.head_split(cfg, tp)
    (q0, q1), (k0, k1) = split.q[0], split.kv[0]
    return {"query": q1 - q0, "kv": k1 - k0,
            "most_query": max(b - a for a, b in split.q),
            "even": split.even}


def build_cell(arch: str, shape_name: str, mesh: Mesh,
               overrides: Optional[dict] = None,
               device="meta") -> Cell:
    """One rank (global rank 0) of a cell on ``mesh`` (:func:`cell_meta`):
    its plan under the current fake group, its model on ``device`` and
    its step.  Raises :class:`Refused` with the port's message for a cell
    it cannot place."""
    overrides = dict(overrides or {})
    cfg, meta, full = cell_meta(arch, shape_name, mesh, overrides)
    try:
        if meta["mode"] == "train":
            return _train_cell(cfg, full, meta, device)
        if meta["param_mode"] != "tp":
            raise Refused(f"param_mode={meta['param_mode']!r} places "
                          "training state; a serving plan is "
                          "tensor-parallel")
        return _serve_cell(cfg, full, meta, overrides, device)
    except (NotImplementedError, ValueError) as e:
        raise Refused(f"{type(e).__name__}: {e}") from e


def _rows(batch: int, data: int) -> int:
    """A data rank's rows of a global batch (all of them when the data
    axis does not divide it, as the reference's batch specs place it)."""
    return batch // data if batch % data == 0 and batch >= data else batch


def _train_cell(cfg, full, meta, device) -> Cell:
    D, M = meta["placement"]["data"], meta["placement"]["model"]
    plan = dry.rank_plan(D, M, training=True, fsdp=meta["fsdp"],
                         mode=meta["param_mode"])
    model = Model(cfg, device, plan)
    opt_cfg = OptimizerConfig(state_dtype="bfloat16",
                              factored=meta["optimizer"]["factored"])
    batch, seq = meta["batch"], meta["seq"]

    def make_args(dev):
        params = _params(model, full, dev)
        state = {"params": params,
                 "opt": init_opt_state(params, opt_cfg, model.layout)}
        dec = min(cfg.max_dec_len, seq) if cfg.is_encdec else seq
        data = {"tokens": torch.zeros((batch, dec), dtype=torch.int32,
                                      device=dev)}
        data["labels"] = torch.zeros_like(data["tokens"])
        if cfg.is_encdec:
            data["frames"] = torch.zeros((batch, seq, cfg.d_model),
                                         dtype=torch.bfloat16, device=dev)
        return state, data

    return Cell(model, meta, make_args, make_train_step(model, opt_cfg))


def _replicated_cache(model: Model, batch: int, seq: int, device) -> dict:
    """``cache_replicate_model``: every rank allocates the attention K/V
    of all KV heads and attends through a view of its own heads' slice
    (MLA's latent and the recurrent states are the rank's as ever)."""
    plan = model.plan
    whole = Model(model.cfg, device).make_cache(batch, seq, device=device)
    cache = model.make_cache(batch, seq, device=device)
    kv, wkv = cache.get("attn_kv", cache), whole.get("attn_kv", whole)
    first = sharding.head_split(model.cfg, plan.tp).kv[plan.rank][0]
    for name in ("k", "v"):
        if name in kv and kv[name].shape != wkv[name].shape:
            kv[name] = wkv[name].narrow(3, first, kv[name].shape[3])
    return cache


def _serve_cell(cfg, full, meta, overrides, device) -> Cell:
    D, M = meta["placement"]["data"], meta["placement"]["model"]
    seq, rows = meta["seq"], meta["rank_batch"]
    decode = meta["mode"] == "decode"
    prefer_seq = meta["cache_prefer_seq"]
    replicate = overrides.get("cache_replicate_model", False)
    if prefer_seq and (replicate or meta["fsdp"]):
        raise Refused("cache_prefer_seq with cache_replicate_model or fsdp: "
                      "a sequence-sharded cache serves under a serving plan "
                      "of its own")
    # ZeRO-3 at serving (the reference's prefill cells above the threshold):
    # the rank's model under the FSDP plan of the whole mesh, each layer's
    # leaves gathered over 'data' as it starts (distributed.fsdp)
    plan = (dry.rank_plan(D, M, training=True, fsdp=True) if meta["fsdp"]
            else dry.rank_plan(D, M, prefer_seq=prefer_seq))
    model = Model(cfg, device, plan)
    # the reference's input shapes (its registry's input_specs): enc-dec
    # prefills frames [rows, seq, D] and min(max_dec_len, seq) tokens, and
    # decodes at its last decoder position
    dec = min(cfg.max_dec_len, seq) if cfg.is_encdec else seq

    def make_args(dev):
        model.layout       # the FSDP layout is built before the trace
        params = _params(model, full, dev)
        cache = (_replicated_cache(model, rows, seq, dev) if replicate
                 else model.make_cache(rows, seq, device=dev))
        if decode:
            return params, cache, {"tokens": torch.zeros(
                (rows, 1), dtype=torch.int32, device=dev)}
        inputs = {"tokens": torch.zeros((rows, dec), dtype=torch.int32,
                                        device=dev)}
        if cfg.is_encdec:
            inputs["frames"] = torch.zeros((rows, seq, cfg.d_model),
                                           dtype=model.dtype, device=dev)
        return params, cache, inputs

    def step(params, cache, inputs):
        with fsdp.use_layout(model.layout):
            if decode:
                return model.decode_step(params, cache, inputs, dec - 1)
            return model.prefill(params, inputs, cache)
    return Cell(model, meta, make_args, step)


def _trace(cell: Cell) -> tuple:
    """The cell's step on ``meta``: (memory reckoning, collectives,
    card_lacks)."""
    args = cell.make_args("meta")
    sharding.reset_collective_stats()
    with sharding.counting_meta(), grad.noting_card_lacks() as lacks:
        out, mem = dry.peak_bytes(lambda: cell.step(*args), args)
    del out
    stats = sharding.collective_stats()
    return ({"argument_size_in_bytes": mem["argument_bytes"],
             "output_size_in_bytes": mem["output_bytes"],
             "temp_size_in_bytes": mem["peak_above_arguments"]},
            rl.collective_bytes(stats), sorted(lacks))


def _on_card(cell: Cell, device) -> dict:
    """The step on the card: drawn from the seed on the card, warmed once
    (cuBLAS's workspace), then run once more with its peak bytes above
    the arguments, its device milliseconds and its collectives."""
    if cell.meta["mode"] == "train":
        raise Refused("a bf16 train step on the card needs bf16 backward "
                      f"kernels ({grad.BF16_BWD})")
    args = cell.make_args(device)
    cell.step(*args)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    sharding.reset_collective_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = cell.step(*args)
    end.record()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del out
    return {"argument_bytes": base, "peak_above_arguments": peak,
            "step_ms": start.elapsed_time(end),
            "collectives": rl.collective_bytes(sharding.collective_stats())}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             mesh: Optional[Mesh] = None, verbose: bool = True,
             overrides: Optional[dict] = None, device="cuda") -> dict:
    """The artifact of one cell (see the module doc): rank 0 of ``mesh``
    under a fake process group set up and torn down here.  ``device``
    'meta' reckons only; a CUDA device also runs the step on the card."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.models.registry import resolve_device
        dev = resolve_device(dev)
    t0 = time.perf_counter()
    with dry.fake_world(mesh.size):
        try:
            cell = build_cell(arch, shape_name, mesh, overrides, "meta")
        except Refused as e:
            return _refused(arch, shape_name, mesh, overrides, str(e), verbose)
        t_build = time.perf_counter() - t0
        try:
            memory, coll, lacks = _trace(cell)
        except NotImplementedError as e:
            return _refused(arch, shape_name, mesh, overrides,
                            f"{type(e).__name__}: {e}", verbose, cell.meta)
        t_trace = time.perf_counter() - t0 - t_build
        card = None
        if dev.type == "cuda":
            try:
                card_cell = build_cell(arch, shape_name, mesh, overrides, dev)
                card = _on_card(card_cell, dev)
            except Refused as e:
                card = {"refused": str(e)}
    meta = cell.meta
    memory["analytic_state_bytes_per_device"] = meta["state_bytes_per_device"]
    from repro_torch.launch.analytic_cost import step_cost
    sc = step_cost(arch, shape_name)
    mf = rl.model_flops_estimate(arch, meta["mode"], meta["batch"],
                                 meta["seq"])
    terms = rl.terms_from_analytic(sc.flops, sc.hbm_bytes,
                                   coll["total_bytes"], mesh.size, mf)
    artifact = {
        "meta": meta,
        "device": str(dev),
        "timing": {"build_s": t_build, "trace_s": t_trace},
        "memory": memory,
        "analytic": {"flops_global": sc.flops,
                     "hbm_bytes_global": sc.hbm_bytes},
        "collectives": coll,
        "model_flops_global": mf,
        "roofline": {
            "hw": terms.hw.name,
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "useful_ratio": terms.useful_ratio,
            "roofline_fraction": terms.roofline_fraction,
        },
        "card_lacks": lacks,
    }
    if card is not None:
        artifact["card"] = card
    if verbose:
        r = artifact["roofline"]
        print(f"[{arch} x {shape_name} x {mesh.tag}] "
              f"trace={t_trace:.1f}s "
              f"state/dev={fmt_bytes(meta['state_bytes_per_device'])} "
              f"peak={fmt_bytes(memory['temp_size_in_bytes'])} "
              f"compute={r['compute_s']*1e3:.2f}ms mem={r['memory_s']*1e3:.2f}ms "
              f"coll={r['collective_s']*1e3:.2f}ms dom={r['dominant']} "
              f"frac={r['roofline_fraction']:.3f}"
              + (f" lacks={lacks}" if lacks else ""))
        if card is not None:
            print(f"  card: {card}")
    return artifact


def _refused(arch, shape_name, mesh, overrides, message, verbose,
             meta=None) -> dict:
    sh = SHAPES[shape_name]
    meta = meta or {"arch": arch, "shape": shape_name, "mode": sh["mode"],
                    "seq": sh["seq"], "batch": sh["batch"],
                    "overrides": dict(overrides or {}),
                    "mesh": dict(mesh.axes)}
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh.tag}] refused: {message}")
    return {"meta": meta, "refused": message}


def artifact_path(arch: str, shape_name: str, multi_pod: bool,
                  out_dir: Optional[str] = None) -> str:
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    out_dir = out_dir or ARTIFACT_DIR
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", help="artifact directory (default "
                    "artifacts/dryrun_torch/)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (one rank on the card, after the meta "
                         "reckoning) or 'meta' (the reckoning only)")
    args = ap.parse_args(argv)

    if args.all:
        todo = cells()
        meshes = (True,) if args.multi_pod else (False, True)
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        todo = [(args.arch, args.shape)]
        meshes = (args.multi_pod,)

    failures, refused, done = [], [], 0
    for multi_pod in meshes:
        for arch, shape_name in todo:
            path = artifact_path(arch, shape_name, multi_pod, args.out)
            if args.skip_existing and os.path.exists(path):
                print(f"skip {arch} x {shape_name} (exists)")
                continue
            try:
                art = run_cell(arch, shape_name, multi_pod=multi_pod,
                               device=args.device)
                with open(path, "w") as f:
                    json.dump(art, f, indent=1)
                done += 1
                if "refused" in art:
                    refused.append((arch, shape_name, multi_pod))
            except Exception:
                traceback.print_exc()
                failures.append((arch, shape_name, multi_pod))
    print(f"dry-run: {done} cells written, {done - len(refused)} run, "
          f"{len(refused)} refused, {len(failures)} failed")
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
