"""Several tensor-parallel instances on the CPU: four gloo ranks, two rank
groups of two, against the JAX package on one device.

One spawn of ``ServingMesh(2, 2)`` per module (``repro_torch.distributed
.spawn(..., data=2)``, gloo, the divergence guard on) serves the smoke
smollm at 2 layers (2 query / 1 KV heads per rank) through
``FaaSRuntime(mesh=ServingMesh(2, 2))``; every rank holds its shard of
the JAX package's weights (``convert.params_from_jax(..., plan=)``).  The
port's counterparts of ``tests/test_sharded_runtime.py``'s multi-instance
runtime tests, each its own test:

  * two functions spread over the two rank groups, cold, cold and warm,
    with the JAX ``Engine``'s greedy tokens, one KV pool per instance,
    and each fork's bytes reported by the two ranks of its group alike;
  * locality routing keeps a warm function's new engine on its rank
    group, and sends another function to the other;
  * ``evict`` brings every pool back to its baseline, read on every rank
    of its instance;
  * template-prefix bakes: at deploy on instance 0, lazily at the first
    fork onto instance 1, a hit on each instance with the JAX tokens,
    one pinned page each, released on every instance.

The serve CLI's ``--instances 2 --tp 2`` runs too.  The rank functions
import no JAX (each rank process imports this module).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tidal  # noqa: E402
from repro_torch.distributed import spawn  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MAX_LEN, PS, NEW = 32, 8, 4


def _cfg():
    return reduced(get_config("smollm-135m"), n_layers=2)


def _prompts() -> dict:
    rng = np.random.default_rng(9)
    tpl = rng.integers(1, 256, PS).astype(np.int32)
    return {"plain": np.arange(1, 11, dtype=np.int32),
            "short": np.arange(3, 11, dtype=np.int32),
            "tpl": tpl,
            "hit": np.concatenate([tpl, rng.integers(1, 256, PS)]
                                  ).astype(np.int32)}


# ---------------------------------------------------------------------------
# what every rank runs (no JAX here)
# ---------------------------------------------------------------------------

def _pool_free(pool) -> tuple:
    return (pool.n_free_slots, pool.n_free_pages, pool.n_available_pages)


def _instances(rt, name: str) -> list:
    return [w.instance for k, w in rt._engines.items() if k[0] == name]


def _per_rank_free(group, rt) -> dict:
    return {key: group.gather(_pool_free, pool)
            for key, pool in rt._pools.items()}


def _serve(group, fns: dict) -> dict:
    from repro_torch.runtime import FaaSRuntime
    from repro_torch.runtime.gateway import InvocationRequest
    pr = _prompts()
    rt = FaaSRuntime(mesh=group.mesh, device="cpu", n_slots=2,
                     max_len=MAX_LEN, page_size=PS, trace_seq=8)
    rt.deploy(fns["a"], {}, prewarm_seq=8)
    rt.deploy(fns["b"], {}, prewarm_seq=8)
    out = {"n_instances": len(rt.instances),
           "ranks": [list(inst.ranks) for inst in rt.instances]}

    def run(name, event=None, prompt="plain"):
        return rt.submit(InvocationRequest(name, pr[prompt], event=event,
                                           max_new_tokens=NEW)).result()

    # spread and parity
    rows = [run("fn-a"), run("fn-b"), run("fn-a")]
    out["spread"] = {
        "kinds": [r.kind for r in rows],
        "tokens": [r.tokens.tolist() for r in rows],
        "placed": {n: _instances(rt, n) for n in ("fn-a", "fn-b")},
        "pools": sorted(k[0] for k in rt._pools),
        "fork_bytes": [[(s.streamed_bytes, s.reused_bytes)
                        for s in r.fork_stats.per_rank] for r in rows[:2]]}
    # locality
    rt.evict()
    run("fn-a", {"v": 0}, "short")
    run("fn-a", {"v": 1}, "short")
    run("fn-b", None, "short")
    out["locality"] = {n: _instances(rt, n) for n in ("fn-a", "fn-b")}
    # evict restores every rank's pools
    rt.evict()
    baseline = rt.kv_pool_stats()
    ranks_before = _per_rank_free(group, rt)
    after = []
    for _ in range(2):
        run("fn-a", None, "short")
        run("fn-b", None, "short")
        rt.evict()
        after.append((rt.kv_pool_stats() == baseline,
                      _per_rank_free(group, rt) == ranks_before))
    out["evict"] = {"baseline": list(baseline.values()), "after": after,
                    "ranks": list(ranks_before.values())}
    # template-prefix bakes per instance
    rt.deploy(fns["tpl"], {}, prewarm_seq=8, template_prompt=pr["tpl"])
    rt.deploy(fns["tpl2"], {}, prewarm_seq=8, template_prompt=pr["tpl"])
    baked = [sorted(k[1] for k in rt._prefix_handles if k[0] == n)
             for n in ("fn-tpl", "fn-tpl2")]
    run("fn-a", None, "short")                   # instance 0 busier
    hits = [run("fn-tpl", None, "hit"), run("fn-tpl2", None, "hit")]
    placed = [_instances(rt, n) for n in ("fn-tpl", "fn-tpl2")]
    refs = {}
    for (name, inst, _), handle in rt._prefix_handles.items():
        refs[f"{name}@{inst}"] = handle.pool.prefix_page_refs(handle)
    rt.evict()
    released = [rt.release_template_prefix(n) for n in ("fn-tpl", "fn-tpl2")]
    out["prefix"] = {
        "deploy_baked": baked, "placed": placed, "refs": refs,
        "hits": [(r.kind, r.reused_prefix_len, r.tokens.tolist())
                 for r in hits],
        "released": released,
        "pages_free": [p.n_free_pages == p.n_pages - 1
                       for p in rt._pools.values()],
        "ranks": list(_per_rank_free(group, rt).values())}
    return out


def _ranks(group, jax_params) -> dict:
    cfg = _cfg()
    model = get_model(cfg, device="cpu", plan=group.plan)
    params = group.bind(convert.params_from_jax(jax_params, cfg, device="cpu",
                                                plan=group.plan))
    fns = {k: group.bind(tidal.static_function(f"fn-{k}", model, params))
           for k in ("a", "b", "tpl", "tpl2")}
    if not group.is_controller:
        group.serve()
        return None
    return _serve(group, fns)


# ---------------------------------------------------------------------------
# the tests (JAX on this side only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    import jax
    from repro.models.registry import get_smoke_model as jax_smoke
    jm = jax_smoke("smollm-135m", n_layers=2)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def mesh(jax_side):
    return spawn(_ranks, 2, (jax_side[2],), data=2, device="cpu", guard=True,
                 timeout_s=600, collective_timeout_s=120)


@pytest.fixture(scope="module")
def want(jax_side):
    """The JAX single-device ``Engine``'s greedy tokens per prompt."""
    from repro.runtime.engine import Engine
    jm, jp, _ = jax_side
    return {k: np.asarray(Engine(jm, jp, donate_cache=False).generate(
        p[None], max_new_tokens=NEW, cache_len=MAX_LEN).tokens[0]).tolist()
        for k, p in _prompts().items()}


def test_instances_spread_with_parity(mesh, want):
    assert mesh["n_instances"] == 2
    assert mesh["ranks"] == [[0, 1], [2, 3]]
    got = mesh["spread"]
    assert got["kinds"] == ["cold", "cold", "warm"]
    assert got["tokens"] == [want["plain"]] * 3
    assert got["placed"]["fn-a"] != got["placed"]["fn-b"]
    assert got["pools"] == [0, 1]                  # one pool per instance
    # each fork's bytes come from the two ranks of its own group, alike
    for per_rank in got["fork_bytes"]:
        assert len(per_rank) == 2 and per_rank[0] == per_rank[1]
    assert got["fork_bytes"][0] == got["fork_bytes"][1]


def test_locality_routes_to_the_warm_instance(mesh):
    loc = mesh["locality"]
    assert len(loc["fn-a"]) == 2 and loc["fn-a"][0] == loc["fn-a"][1]
    assert loc["fn-b"][0] != loc["fn-a"][0]


def test_evict_restores_the_pool_baseline_on_every_rank(mesh):
    ev = mesh["evict"]
    assert all(st["n_free_slots"] == 2 for st in ev["baseline"])
    assert ev["after"] == [(True, True), (True, True)]
    for ranks in ev["ranks"]:
        assert len(ranks) == 2 and ranks[0] == ranks[1]


def test_template_prefix_bakes_per_instance(mesh, want):
    pre = mesh["prefix"]
    assert pre["deploy_baked"] == [[0], [0]]       # at deploy: instance 0
    assert pre["placed"] == [[1], [0]]             # a fork onto each
    # lazily baked on instance 1 at its first fork there, one page each
    assert pre["refs"] == {"fn-tpl@0": [1], "fn-tpl@1": [1],
                           "fn-tpl2@0": [1]}
    for kind, reused, tokens in pre["hits"]:
        assert kind == "cold" and reused == PS
        assert tokens == want["hit"]
    assert pre["released"] == [2, 1]
    assert all(pre["pages_free"])
    for ranks in pre["ranks"]:
        assert ranks[0] == ranks[1]


def test_serve_cli_instances_tp2_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--instances", "2", "--tp", "2", "--layers", "2", "--functions", "3",
         "--requests", "6", "--prompt-len", "16", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [l for l in res.stdout.splitlines() if l.startswith("req")]
    assert len(lines) == 6
    assert {l.split()[2] for l in lines} <= {"cold", "warm"}
    assert "2 ranks (gloo)" in res.stdout
    assert "instances: 2 rank groups, ranks [[0, 1], [2, 3]] (gloo)" in \
        res.stdout
    assert "warm engines per instance: [" in res.stdout
