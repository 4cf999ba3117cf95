"""Expert parallelism and head-parallel MLA on the CPU: two gloo ranks
against the JAX package on one device.

One spawn of two ranks per module (``repro_torch.distributed.spawn``,
gloo, the divergence guard on) serves three smoke models at 2 layers in
fp32, each with the JAX package's weights converted per rank
(``convert.params_from_jax(..., plan=)``):

  * ``moe``: phi3.5-moe (8 experts, top-2, 1 KV head) at the smoke
    config's dropless capacity factor E/K, 4 experts per rank;
  * ``moe-drop``: the same at capacity factor 1.25, where pairs drop;
  * ``mla``: deepseek-v3 (MLA over a replicated latent arena, a moe
    layer with a shared expert split by columns and rows).

The checks, each its own test:

  * ``FaaSRuntime(mesh=ServingMesh(1, 2))`` serves cold, fork (streamed
    prefill while the weights are in flight), a template-prefix hit and
    warm: greedy tokens equal ``repro.runtime.engine.Engine``'s on one
    device, over the fp and the int8 arena (with drops, the prefix hit's
    suffix-only prefill routes T = its own tokens, so its tokens are
    held against the JAX ``FaaSRuntime``'s same schedule);
  * the first prefill's logits within 1e-5 of the largest |logit| of the
    JAX prefill's (fp32: only the order of the partial sums differs), and
    the sequential ``Engine`` under the plan against the JAX ``Engine``;
  * the ``keep`` masks and expert ids ``moe.watch`` records on the
    controller equal the port's at tp = 1, call for call;
  * every model call makes 2L + 2 collectives (one per attention, one per
    moe layer covering experts and shared expert together, embedding and
    head), prefill and decode;
  * fork bytes per rank sum to the one-device fork's plus the replicated
    leaves once more;
  * the MLA pool's page tables, refcounts and free lists identical on
    both ranks and equal to the JAX pool's, and its latent arena whole
    on each rank;
  * the serve CLI with ``--tp 2`` for both architectures, and
    ``--lora --tp 2`` on the moe base exiting with its ROADMAP item.

The rank functions below import no JAX (each rank process imports this
module).  ``test_torch_tp_specs.py`` holds the specs against JAX's.
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
from repro_torch.distributed import sharding, spawn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MAX_LEN, PS, NEW = 32, 8, 5
L = 2
PHI, DSV3 = "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"
# case -> (architecture, config overrides, weight seed)
CASES = {"moe": (PHI, {}, 1), "moe-drop": (PHI, {"capacity_factor": 1.25}, 2),
         "mla": (DSV3, {}, 3)}
# fp32 logits: the ranks' partial sums meet in a different order than one
# device's products, so they agree to this share of the largest |logit|
LOGIT_TOL = 1e-5


def _cfg(case: str):
    arch, extra, _ = CASES[case]
    return reduced(get_config(arch), n_layers=L, **extra)


def _workload():
    rng = np.random.default_rng(5)
    tpl = rng.integers(1, 256, PS).astype(np.int32)
    p0 = rng.integers(1, 256, 9).astype(np.int32)
    p1 = rng.integers(1, 256, 11).astype(np.int32)
    hit = np.concatenate([tpl, rng.integers(1, 256, 6)]).astype(np.int32)
    return tpl, [("cold", p0), ("fork", p1), ("hit", hit), ("warm", p0)]


def _batch():
    _, reqs = _workload()
    return np.stack([reqs[0][1], reqs[0][1][::-1]])


def _routing(calls) -> list:
    """``moe.watch`` records as host lists: (S, expert ids, keep)."""
    return [(s, idx.tolist(), keep.tolist()) for s, idx, keep in calls]


# ---------------------------------------------------------------------------
# what every rank runs (no JAX here)
# ---------------------------------------------------------------------------

def _pool_state(pool) -> tuple:
    return (pool.page_table.tolist(), pool._page_refs.tolist(),
            sorted(pool._free_pages), pool.n_free_slots,
            pool.n_available_pages, dict(pool.stats))


def _arena_shapes(pool) -> dict:
    return {k: tuple(t.shape) for k, t in pool.cache.items()}


def _faas_pass(group, fn, kv_dtype, tpl, reqs) -> dict:
    from repro_torch.runtime import FaaSRuntime
    from repro_torch.runtime.gateway import InvocationRequest
    rt = FaaSRuntime(mesh=group.mesh, device="cpu", n_slots=2,
                     max_len=MAX_LEN, page_size=PS, trace_seq=8,
                     kv_dtype=kv_dtype)
    rt.deploy(fn, {}, template_prompt=tpl, prewarm_seq=8)
    out = {"requests": []}
    for kind, prompt in reqs:
        if kind == "fork":
            rt.evict(fn.name)
        res = rt.submit(InvocationRequest(fn.name, prompt,
                                          max_new_tokens=NEW)).result()
        row = {"kind": res.kind, "tokens": res.tokens.tolist(),
               "streamed": res.streamed_prefill,
               "reused": res.reused_prefix_len}
        if res.fork_stats is not None:
            row["fork"] = [(s.streamed_bytes, s.reused_bytes,
                            s.replicated_bytes)
                           for s in res.fork_stats.per_rank]
        out["requests"].append(row)
    out["pool"] = rt.kv_pool_stats()
    rt.evict()
    return out


def _collectives(call) -> int:
    sharding.reset_collective_stats()
    call()
    return sharding.collective_stats()["calls"]


def _pool_ops(group, model) -> dict:
    """A fixed operation sequence on a latent pool, the state on every
    rank."""
    from repro_torch.runtime.kv_pool import PagedKVCachePool
    pool = PagedKVCachePool(model, 3, 32, page_size=4, n_pages=20,
                            plan=group.plan)
    owner = pool.register_owner("a")
    toks = np.arange(1, 11, dtype=np.int32)
    h = pool.bake_prefix(model.make_cache(1, 12), toks)
    s0 = pool.alloc(12, 4, shared_prefix=h, reuse_len=10, owner=owner)
    pool.ensure_len(s0, 15, owner=owner)
    s1 = pool.alloc(6, 4, budget_tokens=8, owner=owner)
    ok = pool.extend_budget(s1, 10, owner=owner)
    pool.write_prompt(s1, model.make_cache(1, 8), 6, owner=owner)
    pool.release(s0, owner=owner)
    pool.release_prefix(h)
    return {"slots": [s0, s1], "extended": ok,
            "states": group.gather(_pool_state, pool),
            "arenas": group.gather(_arena_shapes, pool)}


def _ranks(group, jax_params: dict) -> dict:
    """Every scenario, on every rank: the workers serve, the controller
    drives and returns what the tests check."""
    tpl, reqs = _workload()
    models, fns, params = {}, {}, {}
    for case in CASES:
        cfg = _cfg(case)
        models[case] = get_model(cfg, device="cpu", plan=group.plan)
        params[case] = group.bind(convert.params_from_jax(
            jax_params[case], cfg, device="cpu", plan=group.plan))
        fns[case] = group.bind(tidal.static_function(case, models[case],
                                                     params[case]))
    if not group.is_controller:
        group.serve()
        return None
    from repro_torch.runtime.engine import Engine
    out = {}
    for case in CASES:
        m, p = models[case], params[case]
        r = {"fp": _faas_pass(group, fns[case], None, tpl, reqs),
             "int8": _faas_pass(group, fns[case], "int8", tpl, reqs)}
        cache = m.make_cache(1, MAX_LEN)
        prompt = reqs[0][1][None]
        got = {}
        r["prefill_collectives"] = _collectives(lambda: got.update(
            logits=m.prefill(p, {"tokens": prompt}, cache)[0]))
        r["logits"] = got["logits"].numpy()
        r["decode_collectives"] = _collectives(lambda: m.decode_step(
            p, cache, {"tokens": np.ones((1, 1), np.int32)}, prompt.shape[1]))
        with moe.watch() as calls:
            r["engine"] = Engine(m, p).generate(_batch(), NEW,
                                                cache_len=MAX_LEN).tokens
        r["routing"] = _routing(calls)
        r["local"] = {"heads": m.local_cfg.n_heads,
                      "experts": m.local_cfg.expert_range,
                      "shared": m.local_cfg.shared_width}
        out[case] = r
    out["pool"] = _pool_ops(group, models["mla"])
    return out


# ---------------------------------------------------------------------------
# the tests (JAX on this side only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    import jax
    from repro.models.registry import get_smoke_model as jax_smoke
    out = {}
    for case, (arch, extra, seed) in CASES.items():
        jm = jax_smoke(arch, n_layers=L, **extra)
        jp = jm.init_params(jax.random.PRNGKey(seed))
        out[case] = (jm, jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def tp(jax_side):
    return spawn(_ranks, 2, ({c: v[2] for c, v in jax_side.items()},),
                 device="cpu", guard=True, timeout_s=600,
                 collective_timeout_s=120)


@pytest.fixture(scope="module")
def one_device(jax_side):
    """The port at tp = 1 over the same weights: the sequential Engine's
    routing records (``moe.watch``)."""
    from repro_torch.runtime.engine import Engine
    out = {}
    for case in CASES:
        cfg = _cfg(case)
        m = get_model(cfg, device="cpu")
        p = convert.params_from_jax(jax_side[case][2], cfg, device="cpu")
        with moe.watch() as calls:
            tokens = Engine(m, p).generate(_batch(), NEW,
                                           cache_len=MAX_LEN).tokens
        out[case] = {"model": m, "params": p, "routing": _routing(calls),
                     "tokens": tokens}
    return out


@pytest.fixture(scope="module")
def engine_tokens(jax_side):
    """The JAX single-device ``Engine``'s greedy tokens per prompt."""
    from repro.runtime.engine import Engine
    _, reqs = _workload()
    return {case: [np.asarray(Engine(jm, jp).generate(
        prompt[None], max_new_tokens=NEW, cache_len=MAX_LEN).tokens[0]
        ).tolist() for _, prompt in reqs]
        for case, (jm, jp, _) in jax_side.items()}


@pytest.fixture(scope="module")
def jax_faas_tokens(jax_side):
    """The JAX ``FaaSRuntime``'s tokens for the same schedule (fp arena)."""
    from repro.core import api as jax_api
    from repro.runtime.faas import FaaSRuntime
    tpl, reqs = _workload()
    jm, jp, _ = jax_side["moe-drop"]
    rt = FaaSRuntime(n_slots=2, max_len=MAX_LEN, trace_seq=8, page_size=PS)
    fn = jax_api.static_function("moe-drop", jm, jp)
    rt.deploy(fn, {}, template_prompt=tpl, prewarm_seq=8)
    out = []
    for kind, prompt in reqs:
        if kind == "fork":
            rt.evict(fn.name)
        out.append(np.asarray(rt.submit(fn.name, {}, prompt, NEW).tokens
                              ).tolist())
    return out


@pytest.mark.parametrize("arena", ["fp", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_faas_kinds_and_tokens_match_the_jax_engine(tp, engine_tokens,
                                                    jax_faas_tokens, case,
                                                    arena):
    """Cold, fork (streamed), prefix hit and warm over the fp and the int8
    arena give the single-device JAX ``Engine``'s greedy tokens; with
    drops the prefix hit's suffix-only prefill routes a call of its own
    T, so it is held against the JAX runtime's hit."""
    rows = tp[case][arena]["requests"]
    assert [r["kind"] for r in rows] == ["cold", "fork", "warm", "warm"]
    assert rows[1]["streamed"] and rows[2]["reused"] > 0
    want = list(engine_tokens[case])
    if case == "moe-drop":
        want[2] = jax_faas_tokens[2]
    assert [r["tokens"] for r in rows] == want


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_logits_within_fp32_tolerance(tp, jax_side, case):
    import jax.numpy as jnp
    jm, jp, _ = jax_side[case]
    _, reqs = _workload()
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(reqs[0][1][None])},
                         jm.make_cache(1, MAX_LEN))
    want = np.asarray(want)
    got = tp[case]["logits"]
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


@pytest.mark.parametrize("case", list(CASES))
def test_sequential_engine_under_the_plan_matches_jax(tp, jax_side, case):
    from repro.runtime.engine import Engine
    jm, jp, _ = jax_side[case]
    want = Engine(jm, jp).generate(_batch(), NEW, cache_len=MAX_LEN).tokens
    np.testing.assert_array_equal(tp[case]["engine"], np.asarray(want))


@pytest.mark.parametrize("case", list(CASES))
def test_keep_masks_equal_one_device(tp, one_device, case):
    """Every rank routes every token with the replicated router: the
    controller's records (global expert ids and ``keep``) equal the
    port's at tp = 1, call for call; at cf 1.25 pairs drop."""
    got, want = tp[case]["routing"], one_device[case]["routing"]
    assert len(got) == len(want) == L * NEW
    assert got == want
    dropped = sum(k.count(False) for _, _, k in got)
    assert (dropped > 0) == (case == "moe-drop")
    np.testing.assert_array_equal(tp[case]["engine"],
                                  one_device[case]["tokens"])


@pytest.mark.parametrize("case", list(CASES))
def test_the_rank_holds_its_experts_and_heads(tp, case):
    cfg = _cfg(case)
    local = tp[case]["local"]
    assert local["heads"] == cfg.n_heads // 2
    assert tuple(local["experts"]) == (0, cfg.n_experts // 2)   # rank 0
    assert local["shared"] == cfg.shared_width // 2


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_per_model_call(tp, case):
    """One ``all_reduce`` per attention and one per moe layer (experts and
    shared expert together), plus the embedding and the head: 2L + 2."""
    assert tp[case]["prefill_collectives"] == 2 * L + 2
    assert tp[case]["decode_collectives"] == 2 * L + 2


def test_one_all_reduce_per_moe_layer_with_a_shared_expert():
    """The moe block under a plan calls ``sharding.all_reduce`` once,
    covering the expert and the shared expert partials."""
    cfg = _cfg("mla")
    plan = sharding.serving_plan(sharding.ServingMesh(1, 2), rank=1)
    m = get_model(cfg, device="cpu", plan=plan)
    p = m.init_params(seed=0)["layers"][0]["moe"]
    seen = []
    real = sharding.all_reduce
    try:
        sharding.all_reduce = lambda y: seen.append(tuple(y.shape)) or y
        with sharding.use_plan(plan, cfg):
            moe.moe_block(p, torch.randn(2, 3, cfg.d_model), m.local_cfg)
    finally:
        sharding.all_reduce = real
    assert seen == [(2, 3, cfg.d_model)]
    assert m.local_cfg.expert_range == (4, 8)


@pytest.mark.parametrize("case", list(CASES))
def test_fork_bytes_per_rank_sum_to_one_device_plus_replicas(tp, one_device,
                                                             case):
    """Each rank streams its shard (its experts, its heads' columns, its
    slice of the shared expert): the ranks' bytes add up to the
    one-device fork's plus every replicated leaf (router, norms, MLA's
    a-side) once more."""
    from repro_torch.runtime import FaaSRuntime
    rt = FaaSRuntime(device="cpu", n_slots=2, max_len=MAX_LEN, page_size=PS,
                     trace_seq=8, prewarm=False)
    rt.deploy(tidal.static_function("one", one_device[case]["model"],
                                    one_device[case]["params"]), {})
    _, one = rt.server.fork("one", {})
    for row in tp[case]["fp"]["requests"][:2]:
        streamed, reused, replicated = zip(*row["fork"])
        assert len(set(replicated)) == 1 and replicated[0] > 0
        assert sum(streamed) + sum(reused) == (
            one.streamed_bytes + one.reused_bytes + replicated[0])
        assert len(set(streamed)) == 1       # equal shards


def test_latent_pool_identical_on_ranks_and_equal_to_jax(tp, jax_side):
    """The latent arena is whole on each rank (the rank's configuration
    keeps kv_lora_rank and qk_rope_dim) and the pool's host state follows
    the JAX pool's."""
    from repro.runtime.kv_pool import PagedKVCachePool
    jm = jax_side["mla"][0]
    pool = PagedKVCachePool(jm, 3, 32, page_size=4, n_pages=20)
    owner = pool.register_owner("a")
    h = pool.bake_prefix(jm.make_cache(1, 12), np.arange(1, 11, dtype=np.int32))
    s0 = pool.alloc(12, 4, shared_prefix=h, reuse_len=10, owner=owner)
    pool.ensure_len(s0, 15, owner=owner)
    s1 = pool.alloc(6, 4, budget_tokens=8, owner=owner)
    ok = pool.extend_budget(s1, 10, owner=owner)
    pool.write_prompt(s1, jm.make_cache(1, 8), 6, owner=owner)
    pool.release(s0, owner=owner)
    pool.release_prefix(h)
    got = tp["pool"]
    assert got["slots"] == [s0, s1] and got["extended"] == ok
    assert got["states"][0] == got["states"][1]
    assert tuple(got["states"][0]) == (
        np.asarray(pool.page_table).tolist(),
        np.asarray(pool._page_refs).tolist(), sorted(pool._free_pages),
        pool.n_free_slots, pool.n_available_pages, dict(pool.stats))
    whole = {k: tuple(v.shape) for k, v in pool.cache.items()}
    assert got["arenas"] == [whole, whole]


@pytest.mark.parametrize("arch", [PHI, DSV3])
def test_serve_cli_tp2_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--tp", "2", "--layers", "2", "--arch", arch, "--functions", "2",
         "--requests", "6", "--prompt-len", "16", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [l for l in res.stdout.splitlines() if l.startswith("req")]
    assert len(lines) == 6
    assert {l.split()[2] for l in lines} == {"cold", "warm"}
    assert "2 ranks" in res.stdout and "gloo" in res.stdout
    assert "4 experts per rank" in res.stdout


def test_serve_cli_lora_tp2_on_a_moe_base_names_its_item():
    """``--lora --tp 2`` serves a dense or a moe base with GQA attention
    (test_torch_tp_lora.py); on deepseek-v3, a moe base with MLA
    attention, ``--lora`` still exits naming it, as the reference's
    does: the adapters target a GQA projection MLA does not have."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--tp", "2", "--layers", "2", "--arch", DSV3, "--lora"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert res.returncode != 0
    assert "MLA attention" in res.stderr
