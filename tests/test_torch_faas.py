"""The port's ``FaaSRuntime``, held against the JAX one on the CPU.

One request schedule (a static function with a template prompt and a
LoRA function, smoke smollm at 2 layers, fp32, the same weights carried
by ``convert.params_from_jax``) goes through both runtimes: the service
kinds, greedy tokens, template-prefix reuse, ``ExecutableCache`` hits and
misses, per-function counters and the KV pool counts after the drain
must all agree.  Keep-alive expiry drops the same engines.  The serve CLI
runs end to end on the CPU and prints all three service classes.
"""

import os
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.api as jax_api  # noqa: E402
import repro.runtime.faas as jax_faas  # noqa: E402
import repro_torch.core.api as torch_api  # noqa: E402
import repro_torch.runtime.faas as torch_faas  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MAX_LEN, PS = 32, 8


@pytest.fixture(scope="module")
def pkgs():
    jm = jax_smoke("smollm-135m", n_layers=2)
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=2)
    jps = [jm.init_params(jax.random.PRNGKey(s)) for s in (0, 1)]
    tps = [convert.params_from_jax(jax.tree.map(np.asarray, p), tm.cfg,
                                   device="cpu") for p in jps]
    return [types.SimpleNamespace(api=jax_api, model=jm, params=jps,
                                  runtime=jax_faas.FaaSRuntime),
            types.SimpleNamespace(api=torch_api, model=tm, params=tps,
                                  runtime=lambda **kw: torch_faas.FaaSRuntime(
                                      device="cpu", **kw))]


def _deploy(P, template, **kw):
    rt = P.runtime(n_slots=2, max_len=MAX_LEN, trace_seq=8, page_size=PS, **kw)
    rt.deploy(P.api.static_function("fn-s", P.model, P.params[0]), {},
              prewarm_seq=8, template_prompt=template)
    rt.deploy(P.api.lora_function("fn-l", P.model, P.params[1],
                                  ["blocks.attn.wq"], n_adapters=3),
              {"adapter": "adapter-0"}, prewarm_seq=8)
    return rt


def test_service_kinds_tokens_and_counts_match_jax(pkgs):
    rng = np.random.default_rng(0)
    template = rng.integers(0, 256, 12).astype(np.int32)
    with_tpl = np.concatenate([template, rng.integers(0, 256, 6).astype(np.int32)])
    plain = rng.integers(0, 256, 9).astype(np.int32)
    schedule = [("fn-s", {}, with_tpl, 5), ("fn-s", {}, plain, 4),
                ("fn-l", {"adapter": "adapter-0"}, plain, 4),
                ("fn-l", {"adapter": "adapter-1"}, with_tpl, 5),
                ("fn-s", {}, with_tpl, 3), "evict", ("fn-s", {}, plain, 4),
                ("fn-l", {"adapter": "adapter-1"}, plain, 3)]
    outs = []
    for P in pkgs:
        rt = _deploy(P, template)
        deploy_counts = (rt.exe_cache.stats.hits, rt.exe_cache.stats.misses)
        rows = []
        for step in schedule:
            if step == "evict":
                rows.append(("evicted", rt.evict("fn-s")))
                continue
            r = rt.submit(*step)
            rows.append((r.kind, r.status, r.reused_prefix_len,
                         r.tokens.tolist(),
                         None if r.fork_stats is None
                         else r.fork_stats.new_dynamic != ()))
        batch = rt.submit_many([("fn-s", {}, with_tpl, 4),
                                ("fn-l", {"adapter": "adapter-2"}, plain, 4)])
        rows.append([(r.kind, r.tokens.tolist()) for r in batch])
        funcs = rt.stats()["functions"]
        outs.append({"rows": rows, "deploy_cache": deploy_counts,
                     "cache": (rt.exe_cache.stats.hits,
                               rt.exe_cache.stats.misses),
                     "pools": list(rt.kv_pool_stats().values()),
                     "engines": rt.warm_engines(), "stats": funcs})
    jax_out, port_out = outs
    assert port_out == jax_out
    kinds = [r[0] for r in port_out["rows"][:-1]]
    assert kinds == ["cold", "warm", "cold", "fork", "warm", "evicted",
                     "fork", "warm"]
    # the template prompt was reused suffix-only (bucketed to a page)
    assert port_out["rows"][0][2] > 0 and port_out["rows"][4][2] > 0
    assert port_out["stats"]["fn-s"]["reuse_hits"] >= 2


def test_fork_streams_and_reports_bytes(pkgs):
    """A fork's admission prefills layer-streamed; its byte accounting
    covers the whole model exactly once."""
    P = pkgs[1]
    rt = _deploy(P, None, prewarm=False)
    t = rt.server.templates["fn-l"]
    r = rt.submit("fn-l", {"adapter": "adapter-1"}, np.arange(9, dtype=np.int32), 3)
    fs = r.fork_stats
    assert r.kind == "cold" and r.streamed_prefill
    assert fs.reused_bytes + fs.streamed_bytes + fs.dynamic_bytes == t.total_bytes
    warm = rt.submit("fn-l", {"adapter": "adapter-1"},
                     np.arange(9, dtype=np.int32), 3)
    assert warm.kind == "warm" and not warm.streamed_prefill
    np.testing.assert_array_equal(warm.tokens, r.tokens)


def test_keep_alive_expiry_matches_jax(pkgs):
    outs = []
    for P in pkgs:
        rt = _deploy(P, None, prewarm=False, keep_alive_s=60.0,
                     max_warm_engines=2)
        p = np.arange(8, dtype=np.int32)
        kinds = [rt.submit("fn-s", {}, p, 2).kind,
                 rt.submit("fn-l", {"adapter": "adapter-0"}, p, 2).kind,
                 rt.submit("fn-l", {"adapter": "adapter-1"}, p, 2).kind]
        capped = rt.warm_engines()                 # LRU cap of 2
        rt._prune(time.perf_counter() + 120.0)     # keep-alive expired
        kinds.append(rt.submit("fn-s", {}, p, 2).kind)
        outs.append((kinds, capped, rt.warm_engines(),
                     list(rt.kv_pool_stats().values())))
    assert outs[0] == outs[1]
    assert outs[1][0] == ["cold", "cold", "fork", "fork"]


def test_later_slices_raise_with_their_item():
    """Several tensor-parallel instances serve now (test_torch_tp_instances
    .py): a ``ServingMesh(2, 2)`` runtime runs on the controller of a
    spawned group of 2 x 2 ranks and says so outside one.  zamba and
    xLSTM build under a plan on any instance's slice (test_torch_tp_ssm
    .py), and so does whisper, whose sequential ``Engine`` raises there
    with the reference's own limit: it takes no plan."""
    from repro_torch.distributed import ServingMesh, serving_plan
    with pytest.raises(RuntimeError, match=r"spawn\(\.\.\., data=2\)"):
        torch_faas.FaaSRuntime(mesh=ServingMesh(2, 2), device="cpu")
    for instance in (0, 1):
        plan = serving_plan(ServingMesh(2, 2), rank=0, instance=instance)
        for arch in ("zamba2-2.7b", "xlstm-1.3b"):
            model = torch_smoke(arch, device="cpu", plan=plan)
            assert model.plan.instance == instance
            assert model.local_cfg.n_heads == model.cfg.n_heads // 2
        # whisper builds under the plan (Model.prefill / decode_step serve
        # it); the sequential Engine takes no plan for it
        from repro_torch.runtime.engine import Engine
        whisper = torch_smoke("whisper-medium", device="cpu", plan=plan)
        assert whisper.local_cfg.n_heads == whisper.cfg.n_heads // 2
        with pytest.raises(NotImplementedError, match="sequential Engine"):
            Engine(whisper, {})


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--layers", "2", "--functions", "2", "--requests", "8", "--lora",
         "--prompt-len", "16", "--max-new", "6"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [l for l in res.stdout.splitlines() if l.startswith("req")]
    assert len(lines) == 8
    kinds = {l.split()[3] for l in lines}
    assert kinds == {"cold", "fork", "warm"}, res.stdout
    assert "p50 ttft" in res.stdout
    # --instances 2 --tp 2 serves (test_torch_tp_instances.py), a zamba
    # base too; whisper under --tp exits: enc-dec serves through the
    # sequential Engine only, as in the reference
    two = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--instances", "2",
         "--tp", "2", "--arch", "zamba2-2.7b", "--device", "cpu",
         "--functions", "2", "--requests", "4", "--prompt-len", "16",
         "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert two.returncode == 0, two.stdout + two.stderr
    assert "instances: 2 rank groups" in two.stdout
    assert len([l for l in two.stdout.splitlines() if l.startswith("req")]) == 4
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--tp", "2",
         "--arch", "whisper-medium", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert bad.returncode != 0 and "sequential Engine" in bad.stderr


def test_serve_cli_open_loop_predictive_on_the_cpu():
    """Poisson arrivals through the gateway with the control plane
    attached, over LoRA functions."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--layers", "2", "--functions", "2", "--requests", "8", "--lora",
         "--prompt-len", "16", "--max-new", "6", "--open-loop", "--qps", "20",
         "--predictive", "--prewarm-horizon", "0.5"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "control plane attached" in res.stdout
    lines = [l for l in res.stdout.splitlines() if l.startswith("req")]
    assert len(lines) == 8
    assert "open-loop @ 20.0 qps: p50 ttft" in res.stdout
    assert "control plane: {'ticks':" in res.stdout
