"""LoRA under tensor parallelism on the CPU: two gloo ranks against the
JAX package on one device.

One spawn of two ranks per module (``repro_torch.distributed.spawn``,
gloo, the divergence guard on) runs every scenario, for the smoke smollm
at 2 layers with 2 KV heads (split over the ranks) and with 1 (each rank
keeps it); the weights are the JAX package's, converted per rank by
``convert.params_from_jax(..., plan=)``.  The checks, each its own test:

  * a shared base (``deploy_shared_base`` over wq, wk, wv and wo) with
    three attached adapter functions, served together through
    ``FaaSRuntime(mesh=ServingMesh(1, 2))``, gives the JAX one-device
    runtime's greedy tokens, kinds and bank rows;
  * a merged ``lora_function`` served cold, by a fork onto another
    adapter (its dynamic weights replayed on each rank) and warm gives
    the JAX runtime's tokens;
  * the first prefill's logits, through a bank row and through the
    merged weights, within 1e-5 of the largest |logit| of the JAX
    prefill's (fp32);
  * each rank's bank shards, put back together along the dimension
    their spec splits, equal the JAX one-device bank after the same
    loads, and row 0 stays null on every rank;
  * every call runs 2L + 2 collectives on each rank, the adapters adding
    none.

The rank functions import no JAX (each rank process imports this
module).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tidal  # noqa: E402
from repro_torch.distributed import sharding, spawn  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402

MAX_LEN, PS, NEW = 32, 4, 6
KVS = (2, 1)
ALL = ("blocks.attn.wq", "blocks.attn.wk", "blocks.attn.wv", "blocks.attn.wo")
ADAPTERS = ((1, 0.7), (2, 1.3), (3, 0.4))      # (seed, alpha) of fn-1..3
FNS = ("base", "fn-1", "fn-2", "fn-3")
MERGED = ("cold", "adapter-0"), ("fork", "adapter-1"), ("warm", "adapter-1")


def _cfg(kv: int):
    return reduced(get_config("smollm-135m"), n_layers=2, n_kv_heads=kv)


def _prompts() -> dict:
    rng = np.random.default_rng(4)
    return {name: rng.integers(0, 256, 6 + i).astype(np.int32)
            for i, name in enumerate(FNS)}


# ---------------------------------------------------------------------------
# what every rank runs (no JAX here)
# ---------------------------------------------------------------------------

def _bank_arrays(bank) -> dict:
    return {n: {k: t.numpy() for k, t in slab.items()}
            for n, slab in bank.items()}


def _collectives() -> dict:
    return sharding.collective_stats()


def _reset_collectives() -> None:
    sharding.reset_collective_stats()


def _shared(group, base, model, params) -> dict:
    from repro_torch.runtime import FaaSRuntime
    from repro_torch.runtime.gateway import InvocationRequest
    rt = FaaSRuntime(mesh=group.mesh, device="cpu", n_slots=3,
                     max_len=MAX_LEN, trace_seq=8, page_size=PS,
                     prewarm=False)
    rt.deploy_shared_base(base, n_adapters=4, rank=4, target_paths=ALL)
    for i, (seed, alpha) in enumerate(ADAPTERS, start=1):
        ad = tidal.lora_checkpoint(f"ad{seed}", model, list(ALL), rank=4,
                                   seed=seed)
        rt.attach_adapter(f"fn-{i}", "base", ad, alpha=alpha)
    prompts = _prompts()
    group.gather(_reset_collectives)
    handles = {n: rt.submit(InvocationRequest(n, p, max_new_tokens=NEW))
               for n, p in prompts.items()}
    res = {n: h.result() for n, h in handles.items()}
    warm = rt._engines[("__adapters__", "base", 0)]
    engine = warm.engine
    # the bank engine's calls and the base's own engine's
    calls = sum(w.engine.n_decode_steps + w.engine.n_prefill_calls
                for w in rt._engines.values())
    collectives = [c["calls"] for c in group.gather(_collectives)]
    # the first prefill through each row, on the ranks' bank
    logits = {}
    for name in FNS:
        aid = warm.adapter_ids.get(name, 0)
        lg, _ = model.prefill(params, {"tokens": prompts[name][None]},
                              model.make_cache(1, 16),
                              adapter_bank=engine.adapter_bank,
                              adapter_ids=[aid])
        logits[name] = lg.numpy()
    out = {"tokens": {n: r.tokens.tolist() for n, r in res.items()},
           "kinds": {n: r.kind for n, r in res.items()},
           "rows": dict(warm.adapter_ids),
           "banks": group.gather(_bank_arrays, engine.adapter_bank),
           "logits": logits, "calls": calls, "collectives": collectives}
    rt.evict()
    out["pools"] = list(rt.kv_pool_stats().values())
    return out


def _merged(group, fn, model) -> dict:
    from repro_torch.runtime import FaaSRuntime
    from repro_torch.runtime.gateway import InvocationRequest
    rt = FaaSRuntime(mesh=group.mesh, device="cpu", n_slots=2,
                     max_len=MAX_LEN, trace_seq=8, page_size=PS)
    rt.deploy(fn, {"adapter": "adapter-0"}, prewarm_seq=8)
    prompt = _prompts()["fn-1"]
    rows = []
    for kind, adapter in MERGED:
        if kind == "fork":
            rt.evict()
        res = rt.submit(InvocationRequest(fn.name, prompt,
                                          event={"adapter": adapter},
                                          max_new_tokens=NEW)).result()
        rows.append((res.kind, res.tokens.tolist()))
    (key,) = [k for k in rt._engines if k[0] == fn.name]
    lg, _ = model.prefill(rt._engines[key].engine.params(),
                          {"tokens": prompt[None]}, model.make_cache(1, 16))
    rt.evict()
    return {"rows": rows, "logits": lg.numpy()}


def _ranks(group, jax_params: dict) -> dict:
    models, bases, merged, params = {}, {}, {}, {}
    for kv in KVS:
        cfg = _cfg(kv)
        models[kv] = get_model(cfg, device="cpu", plan=group.plan)
        params[kv] = group.bind(convert.params_from_jax(
            jax_params[kv], cfg, device="cpu", plan=group.plan))
        bases[kv] = group.bind(tidal.static_function("base", models[kv],
                                                     params[kv]))
        merged[kv] = group.bind(tidal.lora_function(
            "merged", models[kv], params[kv], ["blocks.attn.wq"],
            n_adapters=2))
    if not group.is_controller:
        group.serve()
        return None
    return {kv: {"shared": _shared(group, bases[kv], models[kv], params[kv]),
                 "merged": _merged(group, merged[kv], models[kv])}
            for kv in KVS}


# ---------------------------------------------------------------------------
# the tests (JAX on this side only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    import jax
    from repro.models.registry import get_smoke_model as jax_smoke
    out = {}
    for kv in KVS:
        jm = jax_smoke("smollm-135m", n_layers=2, n_kv_heads=kv)
        jp = jm.init_params(jax.random.PRNGKey(kv))
        out[kv] = (jm, jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def tp(jax_side):
    return spawn(_ranks, 2, ({kv: v[2] for kv, v in jax_side.items()},),
                 device="cpu", guard=True, timeout_s=600,
                 collective_timeout_s=120)


@pytest.fixture(scope="module")
def jax_runs(jax_side):
    """The same schedules on the JAX one-device runtime."""
    import jax
    import jax.numpy as jnp
    import repro.core.api as japi
    from repro.runtime.faas import FaaSRuntime
    from repro.runtime.gateway import InvocationRequest
    out = {}
    for kv, (jm, jp, _) in jax_side.items():
        rt = FaaSRuntime(n_slots=3, max_len=MAX_LEN, trace_seq=8,
                         page_size=PS, prewarm=False)
        rt.deploy_shared_base(japi.static_function("base", jm, jp),
                              n_adapters=4, rank=4, target_paths=ALL)
        for i, (seed, alpha) in enumerate(ADAPTERS, start=1):
            ad = japi.lora_checkpoint(f"ad{seed}", jm, list(ALL), rank=4,
                                      seed=seed)
            rt.attach_adapter(f"fn-{i}", "base", ad, alpha=alpha)
        prompts = _prompts()
        handles = {n: rt.submit(InvocationRequest(n, p, max_new_tokens=NEW))
                   for n, p in prompts.items()}
        res = {n: h.result() for n, h in handles.items()}
        warm = rt._engines[("__adapters__", "base", 0)]
        bank = warm.engine.adapter_bank
        logits = {}
        for name in FNS:
            lg, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompts[name][None])},
                               jm.make_cache(1, 16), adapter_bank=bank,
                               adapter_ids=jnp.asarray(
                                   [warm.adapter_ids.get(name, 0)], jnp.int32))
            logits[name] = np.asarray(lg)
        shared = {"tokens": {n: np.asarray(r.tokens).tolist()
                             for n, r in res.items()},
                  "kinds": {n: r.kind for n, r in res.items()},
                  "rows": dict(warm.adapter_ids),
                  "bank": jax.tree.map(np.asarray, bank), "logits": logits}
        mrt = FaaSRuntime(n_slots=2, max_len=MAX_LEN, trace_seq=8,
                          page_size=PS)
        fn = japi.lora_function("merged", jm, jp, ["blocks.attn.wq"],
                                n_adapters=2)
        mrt.deploy(fn, {"adapter": "adapter-0"}, prewarm_seq=8)
        rows = []
        for kind, adapter in MERGED:
            if kind == "fork":
                mrt.evict()
            r = mrt.submit(InvocationRequest(
                "merged", _prompts()["fn-1"], event={"adapter": adapter},
                max_new_tokens=NEW)).result()
            rows.append((r.kind, np.asarray(r.tokens).tolist()))
        weights = jax.tree.map(lambda t: jnp.asarray(t.materialize()),
                               fn.run_initializer({"adapter": "adapter-1"})[0])
        lg, _ = jm.prefill(weights, {"tokens": jnp.asarray(
            _prompts()["fn-1"][None])}, jm.make_cache(1, 16))
        out[kv] = {"shared": shared,
                   "merged": {"rows": rows, "logits": np.asarray(lg)}}
    return out


def _close(got, want):
    return np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kv", KVS)
def test_shared_base_tokens_kinds_and_rows_match_jax(tp, jax_runs, kv):
    got, want = tp[kv]["shared"], jax_runs[kv]["shared"]
    assert got["tokens"] == want["tokens"]
    assert got["kinds"] == want["kinds"]
    assert got["rows"] == want["rows"] == {"fn-1": 1, "fn-2": 2, "fn-3": 3}
    # the adapters change what the base says
    assert len({tuple(t) for t in got["tokens"].values()}) > 1


@pytest.mark.parametrize("kv", KVS)
def test_merged_lora_function_matches_jax(tp, jax_runs, kv):
    got, want = tp[kv]["merged"]["rows"], jax_runs[kv]["merged"]["rows"]
    assert [k for k, _ in got] == ["cold", "fork", "warm"]
    assert got == want


@pytest.mark.parametrize("kv", KVS)
def test_first_prefill_logits_within_fp32_tolerance(tp, jax_runs, kv):
    for name in FNS:
        assert _close(tp[kv]["shared"]["logits"][name],
                      jax_runs[kv]["shared"]["logits"][name]), name
    assert _close(tp[kv]["merged"]["logits"], jax_runs[kv]["merged"]["logits"])


@pytest.mark.parametrize("kv", KVS)
def test_bank_shards_put_together_equal_the_one_device_bank(tp, jax_runs, kv):
    want = jax_runs[kv]["shared"]["bank"]
    ranks = tp[kv]["shared"]["banks"]
    specs = sharding.adapter_bank_specs(_cfg(kv), [p.rsplit(".", 1)[-1]
                                                   for p in ALL], 2)
    for name, slab in want.items():
        for k, full in slab.items():
            dim = specs[name][k].model_dim
            parts = [r[name][k] for r in ranks]
            got = (np.concatenate(parts, axis=dim) if dim is not None
                   else parts[0])
            np.testing.assert_array_equal(got, full, err_msg=f"{name}.{k}")
            for part in parts:
                assert not part[:, 0].any()               # the null row
                if dim is None:
                    np.testing.assert_array_equal(part, full)


@pytest.mark.parametrize("kv", KVS)
def test_collectives_per_call_and_pool_baseline(tp, kv):
    """2L + 2 collectives per model call on each rank (L = 2): the wo
    delta joins the partial before the layer's one all_reduce."""
    shared = tp[kv]["shared"]
    calls = shared["calls"]
    assert shared["collectives"] == [(2 * 2 + 2) * calls] * 2
    assert all(p["n_free_slots"] == 3 for p in shared["pools"])
