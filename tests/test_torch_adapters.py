"""The port's adapter bank and shared-base serving, held against the JAX one.

Smoke smollm at 2 layers, fp32, the same weights carried by
``convert.params_from_jax`` and the same ``lora_checkpoint`` factors
(both packages draw them from ``numpy.random.default_rng(seed)``).  The
bank built and loaded by the port equals the JAX bank after
``convert.adapter_bank_from_jax`` exactly; ``lora_delta``, a banked
prefill and a banked paged decode agree within 1e-5 / 2e-4 (fp32,
summation order only); and ``FaaSRuntime``'s shared-base serving gives
the JAX runtime's tokens, bank rows, warm engines and errors.  A gathered
adapter's logits against the merged-weight model (``W + alpha * A @ B``)
agree within 1e-4: the two forms are different fp32 arithmetic.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.api as jax_api  # noqa: E402
import repro.models.adapters as jax_adapters  # noqa: E402
import repro.runtime.errors as jax_errors  # noqa: E402
import repro.runtime.faas as jax_faas  # noqa: E402
import repro.runtime.faults as jax_faults  # noqa: E402
import repro.runtime.gateway as jax_gateway  # noqa: E402
import repro_torch.core.api as torch_api  # noqa: E402
import repro_torch.models.adapters as torch_adapters  # noqa: E402
import repro_torch.runtime.errors as torch_errors  # noqa: E402
import repro_torch.runtime.faas as torch_faas  # noqa: E402
import repro_torch.runtime.faults as torch_faults  # noqa: E402
import repro_torch.runtime.gateway as torch_gateway  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402
from repro_torch.runtime.engine import Engine  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
MAX_LEN = 32
ALL = ("blocks.attn.wq", "blocks.attn.wk", "blocks.attn.wv", "blocks.attn.wo")
WQ = ("blocks.attn.wq",)


@pytest.fixture(scope="module")
def pkgs():
    jm = jax_smoke("smollm-135m", n_layers=2)
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=2)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return [types.SimpleNamespace(api=jax_api, adapters=jax_adapters,
                                  errors=jax_errors, faults=jax_faults,
                                  Request=jax_gateway.InvocationRequest,
                                  model=jm, params=jp,
                                  runtime=jax_faas.FaaSRuntime),
            types.SimpleNamespace(api=torch_api, adapters=torch_adapters,
                                  errors=torch_errors, faults=torch_faults,
                                  Request=torch_gateway.InvocationRequest,
                                  model=tm, params=tp,
                                  runtime=lambda **kw: torch_faas.FaaSRuntime(
                                      device="cpu", **kw))]


def _bank(P, targets=ALL, n=3, rank=4):
    """A bank with rows 1 and 2 loaded from seeds 1 and 2."""
    bank = P.adapters.make_adapter_bank(P.model, targets, n, rank)
    for idx, (seed, alpha) in enumerate(((1, 0.7), (2, 1.3)), start=1):
        ad = P.api.lora_checkpoint(f"ad{seed}", P.model, list(targets),
                                   rank=rank, seed=seed)
        bank = P.adapters.load_adapter(bank, idx, ad, P.model, alpha=alpha)
    return bank


def _np_bank(bank):
    return jax.tree.map(np.asarray, bank)


def test_bank_and_load_adapter_match_jax(pkgs):
    J, T = pkgs
    jbank, tbank = _bank(J), _bank(T)
    want = convert.adapter_bank_from_jax(_np_bank(jbank), device="cpu")
    assert sorted(tbank) == sorted(want) == ["wk", "wo", "wq", "wv"]
    for name in want:
        for k in ("a", "b"):
            assert torch.equal(tbank[name][k], want[name][k]), (name, k)
            assert not tbank[name][k][:, 0].any()          # row 0 stays null
    assert T.adapters.bank_n_adapters(tbank) == 3
    for P in pkgs:
        bank = P.adapters.make_adapter_bank(P.model, WQ, 2, 4)
        ad = P.api.lora_checkpoint("x", P.model, ["blocks.attn.wv"], rank=4)
        with pytest.raises(ValueError, match="out of range"):
            P.adapters.load_adapter(bank, 0, ad, P.model)
        with pytest.raises(ValueError, match="bank has no 'wv' slab"):
            P.adapters.load_adapter(bank, 1, ad, P.model)
        with pytest.raises(ValueError, match="only attention projections"):
            P.adapters.make_adapter_bank(P.model, ("blocks.mlp.w_up",), 2, 4)
        with pytest.raises(ValueError, match="n_adapters must be >= 2"):
            P.adapters.make_adapter_bank(P.model, WQ, 1, 4)


@pytest.mark.parametrize("name", ["wq", "wo"])
def test_lora_delta_matches_jax(pkgs, name):
    J, T = pkgs
    jbank = _bank(J)
    tbank = convert.adapter_bank_from_jax(_np_bank(jbank), device="cpu")
    din = J.adapters.target_dims(J.model.cfg, name)[0]
    x = np.random.default_rng(3).standard_normal((3, 5, din)).astype(np.float32)
    ids = np.asarray([2, 0, 1], np.int32)
    want = np.asarray(J.adapters.lora_delta(
        jnp.asarray(x), {k: v[1] for k, v in jbank[name].items()},
        jnp.asarray(ids)))
    got = T.adapters.lora_delta(torch.from_numpy(x),
                                {k: v[1] for k, v in tbank[name].items()},
                                torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert not got[1].any()                                # the null row


def test_banked_prefill_and_paged_decode_match_jax(pkgs):
    """Prefill under one adapter row and a paged decode whose three slots
    carry rows 2, 0 (null) and 1, on the same random arena."""
    J, T = pkgs
    cfg = T.model.cfg
    jbank = _bank(J)
    tbank = convert.adapter_bank_from_jax(_np_bank(jbank), device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (1, 11)).astype(np.int32)
    jl, jc = J.model.prefill(J.params, {"tokens": jnp.asarray(toks)},
                             J.model.make_cache(1, 16), adapter_bank=jbank,
                             adapter_ids=jnp.asarray([1], jnp.int32))
    tl, tc = T.model.prefill(T.params, {"tokens": toks}, T.model.make_cache(1, 16),
                             adapter_bank=tbank, adapter_ids=[1])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=2e-4, rtol=2e-4)

    ps, nb = 4, 4
    shape = (cfg.n_layers, 1 + 3 * nb, ps, cfg.n_kv_heads, cfg.head_dim)
    arena = {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}
    pt = (np.arange(3 * nb, dtype=np.int32) + 1).reshape(3, nb)
    pos = np.asarray([5, 0, 13], np.int32)
    dtok = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    ids = np.asarray([2, 0, 1], np.int32)
    jl, jc = J.model.decode_step_paged(
        J.params, {k: jnp.asarray(v) for k, v in arena.items()},
        {"tokens": jnp.asarray(dtok)}, jnp.asarray(pos), jnp.asarray(pt), ps,
        adapter_bank=jbank, adapter_ids=jnp.asarray(ids))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in arena.items()}
    tl, _ = T.model.decode_step_paged(T.params, tcache, {"tokens": dtok}, pos,
                                      pt, ps, adapter_bank=tbank,
                                      adapter_ids=ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=2e-4)
    for k in "kv":
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jc[k]),
                                   atol=2e-4, rtol=2e-4)


def _merged(params, adapter, alpha, path="blocks.attn.wq"):
    """Port params with ``alpha * A @ B`` merged into every layer's wq."""
    A = adapter.arrays[path + ".A"].numpy()
    B = adapter.arrays[path + ".B"].numpy()
    L = len(params["layers"])
    delta = ((A @ B) * alpha).reshape(L, *params["layers"][0]["attn"]["wq"].shape)
    layers = [{**lp, "attn": {**lp["attn"],
                              "wq": lp["attn"]["wq"] + torch.from_numpy(delta[i])}}
              for i, lp in enumerate(params["layers"])]
    return {**params, "layers": layers}


def _shared_rt(P, n_adapters=4):
    rt = P.runtime(n_slots=3, max_len=MAX_LEN, trace_seq=8, page_size=4,
                   prewarm=False)
    rt.deploy_shared_base(P.api.static_function("base", P.model, P.params),
                          n_adapters=n_adapters, rank=4, target_paths=WQ)
    ads = [P.api.lora_checkpoint(f"ad{s}", P.model, list(WQ), rank=4, seed=s)
           for s in (1, 2)]
    rt.attach_adapter("fn-1", "base", ads[0], alpha=0.7)
    rt.attach_adapter("fn-2", "base", ads[1], alpha=1.3)
    return rt, ads


def test_shared_base_runtime_matches_jax(pkgs):
    """The schedule of tests/test_multitenant.py's merged-weight oracle
    test: the base and two adapter functions submitted together."""
    rng = np.random.default_rng(4)
    prompts = {name: rng.integers(0, 256, 6 + i).astype(np.int32)
               for i, name in enumerate(("base", "fn-1", "fn-2"))}
    outs = []
    for P in pkgs:
        rt, _ = _shared_rt(P)
        handles = {n: rt.submit(P.Request(n, p, max_new_tokens=6))
                   for n, p in prompts.items()}
        res = {n: h.result() for n, h in handles.items()}
        key = ("__adapters__", "base", 0)
        outs.append({"tokens": {n: r.tokens.tolist() for n, r in res.items()},
                     "kinds": {n: r.kind for n, r in res.items()},
                     "engines": rt.warm_engines(),
                     "rows": dict(rt._engines[key].adapter_ids),
                     "pools": list(rt.kv_pool_stats().values()),
                     "stats": rt.stats()["functions"]})
        if P is pkgs[1]:
            port_rt = rt
    assert outs[0] == outs[1]
    assert ("__adapters__", "base", 0) in outs[1]["engines"]
    assert sorted(outs[1]["rows"].values()) == [1, 2]
    # the merged-weight oracle on the port: tokens equal, logits close
    T = pkgs[1]
    _, ads = _shared_rt(T)
    for name, ad, alpha in (("fn-1", ads[0], 0.7), ("fn-2", ads[1], 1.3)):
        merged = _merged(T.params, ad, alpha)
        want = Engine(T.model, merged).generate(prompts[name][None],
                                                max_new_tokens=6).tokens[0]
        assert outs[1]["tokens"][name] == want.tolist()
        bank = port_rt._engines[("__adapters__", "base", 0)].engine.adapter_bank
        aid = outs[1]["rows"][name]
        toks = prompts[name][None]
        lg_bank, _ = T.model.prefill(T.params, {"tokens": toks},
                                     T.model.make_cache(1, 16),
                                     adapter_bank=bank, adapter_ids=[aid])
        lg_merged, _ = T.model.prefill(merged, {"tokens": toks},
                                       T.model.make_cache(1, 16))
        torch.testing.assert_close(lg_bank, lg_merged, atol=1e-4, rtol=1e-4)


def test_bank_full_and_adapter_load_fault_match_jax(pkgs):
    prompt = np.arange(6, dtype=np.int32)
    outs = []
    for P in pkgs:
        rt, _ = _shared_rt(P, n_adapters=2)        # one loadable row
        first = rt.submit(P.Request("fn-1", prompt, max_new_tokens=3)).result()
        with pytest.raises(RuntimeError, match="adapter bank is full"):
            rt.submit(P.Request("fn-2", prompt, max_new_tokens=3))
        rt2, _ = _shared_rt(P)
        plan = P.faults.FaultPlan([P.faults.FaultSpec("adapter_load", at=0)])
        with P.faults.use_fault_plan(plan):
            with pytest.raises(P.errors.AdapterLoadFault):
                rt2.submit(P.Request("fn-1", prompt, max_new_tokens=3))
            retry = rt2.submit(P.Request("fn-1", prompt,
                                         max_new_tokens=3)).result()
        outs.append((first.tokens.tolist(), first.kind, retry.tokens.tolist(),
                     retry.kind, [f["point"] for f in plan.fired],
                     dict(rt2._engines[("__adapters__", "base", 0)].adapter_ids)))
    assert outs[0] == outs[1]
    assert outs[1][0] == outs[1][2]                # the retry serves the row


def test_engine_bank_needs_paged_pool_and_range_checks(pkgs):
    from repro_torch.runtime import ContinuousBatchingEngine
    T = pkgs[1]
    bank = T.adapters.make_adapter_bank(T.model, WQ, 3, 4)
    with pytest.raises(ValueError, match="paged arena only"):
        ContinuousBatchingEngine(T.model, T.params, n_slots=1, max_len=16,
                                 paged=False, adapter_bank=bank)
    eng = ContinuousBatchingEngine(T.model, T.params, n_slots=2, max_len=16,
                                   page_size=4, adapter_bank=bank)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit(np.arange(4), 2, adapter_id=3)
    plain = ContinuousBatchingEngine(T.model, T.params, n_slots=1, max_len=16,
                                     page_size=4)
    with pytest.raises(ValueError, match="no adapter bank"):
        plain.submit(np.arange(4), 2, adapter_id=1)
    with pytest.raises(ValueError, match="without an adapter bank"):
        plain.set_adapter(1, None)
    # a free slot and a finished request's slot carry the null row
    eng.submit(np.arange(5), 4, adapter_id=2)
    eng.step()
    assert eng._aid.tolist() in ([2, 0], [0, 2])
    eng.run()
    assert eng._aid.tolist() == [0, 0]
