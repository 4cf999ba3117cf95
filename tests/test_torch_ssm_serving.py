"""The port's zamba serving path, held against the JAX package on the CPU.

The smoke zamba (4 Mamba2 layers, a shared attention block every 2, fp32,
weights carried by ``convert.params_from_jax``) goes through:

* the dense slot pool: slots and free counts on one alloc / write / read /
  release trace, nested cache leaves written and read back;
* the sequential ``Engine`` and ``ContinuousBatchingEngine`` (dense pool,
  2 slots) on the mixed request trace of ``tests/test_runtime.py``:
  identical greedy tokens;
* the layer-streamed prefill of a forked session: ``torch.equal`` to the
  monolithic prefill (logits and every cache leaf), ``ValueError`` for a
  suffix offset;
* the traced weight order: the JAX zamba order key for key through
  ``convert.jax_key``, the shared block after the first unit and once;
* ``FaaSRuntime``: the evict schedule of ``tests/test_runtime.py`` over
  an attention function (paged pool) and a zamba one (dense pool), with
  kinds, tokens and pool counts equal to the JAX runtime's; template
  prompts, runtime prefixes and shared bases refused for zamba.
"""

import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.api as jax_api  # noqa: E402
import repro.runtime.faas as jax_faas  # noqa: E402
import repro_torch.core.api as torch_api  # noqa: E402
from repro.core.tracing import trace_weight_access as jax_trace  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro.runtime.continuous import ContinuousBatchingEngine as JaxCBE  # noqa: E402
from repro.runtime.engine import Engine as JaxEngine  # noqa: E402
from repro.runtime.kv_pool import KVCachePool as JaxDensePool  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.streaming import (streamed_prefill,  # noqa: E402
                                        supports_streamed_prefill)
from repro_torch.core.template_server import TemplateServer  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402
from repro_torch.runtime import (ContinuousBatchingEngine, Engine,  # noqa: E402
                                 FaaSRuntime, KVCachePool)
from repro_torch.utils import named_leaves  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ARCH = "zamba2-2.7b"
MAX_LEN = 24


def _mixed_requests(vocab, seed=3):
    """The request mix of ``tests/test_runtime.py``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, s).astype(np.int32), n)
            for s, n in [(4, 5), (9, 3), (6, 7), (11, 4), (5, 6)]]


@pytest.fixture(scope="module")
def zamba():
    jm = jax_smoke(ARCH)
    tm = torch_smoke(ARCH, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return jm, jp, tm, tp


def test_dense_pool_slots_and_nested_leaves_match_jax(zamba):
    jm, jp, tm, tp = zamba
    jpool = JaxDensePool(jm, n_slots=3, max_len=8)
    tpool = KVCachePool(tm, n_slots=3, max_len=8)
    trace = []
    for pool in (jpool, tpool):
        a, b = pool.alloc(), pool.alloc()
        pool.release(a)
        c, d = pool.alloc(), pool.alloc()
        pool.release(b)
        trace.append((a, b, c, d, pool.n_free))
        with pytest.raises(ValueError):
            pool.release(b)
    assert trace[0] == trace[1] == (0, 1, 0, 2, 1)
    toks = np.random.default_rng(0).integers(0, 256, (1, 6)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.make_cache(1, 8))
    _, tc = tm.prefill(tp, {"tokens": toks}, tm.make_cache(1, 8))
    jpool.write_slot(2, jc)
    tpool.write_slot(2, tc)
    back = dict(named_leaves(tpool.read_slot(2)))
    jback = jpool.read_slot(2)
    for path, leaf in named_leaves(tc):
        g, k = path.split(".")
        assert torch.equal(back[path], leaf), path
        np.testing.assert_allclose(back[path].numpy(), np.asarray(jback[g][k]),
                                   atol=2e-4, rtol=0)
        assert not dict(named_leaves(tpool.cache))[path][:, 0].any(), path
    assert tpool.nbytes() == sum(int(l.nbytes) for l in jax.tree.leaves(jpool.cache))


def _jax_sequential(jm, jp, reqs):
    eng = JaxEngine(jm, jp, donate_cache=False)
    return [eng.generate(p[None], max_new_tokens=n, cache_len=MAX_LEN).tokens[0]
            for p, n in reqs]


def test_engine_tokens_match_jax(zamba):
    jm, jp, tm, tp = zamba
    prompts = np.random.default_rng(4).integers(0, 256, (2, 16)).astype(np.int32)
    want = JaxEngine(jm, jp, donate_cache=False).generate(
        prompts, max_new_tokens=6).tokens
    got = Engine(tm, tp).generate(prompts, max_new_tokens=6).tokens
    np.testing.assert_array_equal(got, np.asarray(want))


def test_continuous_tokens_match_jax_on_the_mixed_trace(zamba):
    """Two slots for three requests (slot reuse, mid-decode admission),
    the dense pool by default, greedy tokens equal to both JAX engines."""
    jm, jp, tm, tp = zamba
    reqs = _mixed_requests(tm.cfg.vocab_size, seed=1)[:3]
    want = _jax_sequential(jm, jp, reqs)
    jcbe = JaxCBE(jm, jp, n_slots=2, max_len=MAX_LEN)
    jids = [jcbe.submit(p, n) for p, n in reqs]
    jout = jcbe.run()
    cbe = ContinuousBatchingEngine(tm, tp, n_slots=2, max_len=MAX_LEN)
    assert not cbe.paged and isinstance(cbe.pool, KVCachePool)
    ids = [cbe.submit(p, n) for p, n in reqs]
    out = cbe.run()
    for i, j, w in zip(ids, jids, want):
        np.testing.assert_array_equal(out[i].tokens, jout[j].tokens)
        np.testing.assert_array_equal(out[i].tokens, w)
    assert cbe.pool.n_free == 2
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingEngine(tm, tp, n_slots=2, max_len=MAX_LEN, paged=True)


def _register(tm, tp, trace_seq=16):
    srv = TemplateServer(trace_seq=trace_seq)
    tpl = srv.register(torch_api.static_function("z", tm, tp), {})
    return srv, tpl


@pytest.mark.parametrize("S", [32, 13])
def test_streamed_prefill_equals_prefill(zamba, S):
    _, _, tm, tp = zamba
    assert supports_streamed_prefill(tm)
    srv, _ = _register(tm, tp)
    session, stats = srv.fork("z", {})
    toks = np.random.default_rng(5).integers(0, 256, (1, S)).astype(np.int32)
    lg_s, c_s = streamed_prefill(session, {"tokens": toks}, tm.make_cache(1, 40))
    lg_m, c_m = tm.prefill(tp, {"tokens": toks}, tm.make_cache(1, 40))
    assert torch.equal(lg_s, lg_m)
    for (pa, a), (pb, b) in zip(named_leaves(c_s), named_leaves(c_m)):
        assert pa == pb and torch.equal(a, b), pa
    session.streamer.wait_all()
    # the shared block streamed once, every layer's weights in traced order
    order = srv.templates["z"].order
    assert session.streamer.completed_order == [
        k for k in order if k in {e.key for e in session.streamer.entries}]
    with pytest.raises(ValueError, match="offset=8"):
        streamed_prefill(session, {"tokens": toks}, tm.make_cache(1, 40), offset=8)


def test_traced_order_matches_jax(zamba):
    jm, _, tm, tp = zamba
    _, tpl = _register(tm, tp)
    specs = jm.init_params(abstract=True)
    jtr = jax_trace(lambda p, i, c: jm.prefill(p, i, c), specs,
                    jm.input_specs("prefill", 1, 16, dtype=jnp.float32),
                    jm.make_cache(1, 16, abstract=True))
    assert [convert.jax_key(p) for p, _ in tpl.order] == jtr.order
    first_shared = next(i for i, (p, _) in enumerate(tpl.order)
                        if p.startswith("shared_attn."))
    before = {int(p.split(".")[1]) for p, _ in tpl.order[:first_shared]
              if p.startswith("mamba.")}
    assert before == set(range(tm.cfg.attn_every))
    shared = [p for p, _ in tpl.order if p.startswith("shared_attn.")]
    assert len(shared) == len(set(shared)) == len(
        list(named_leaves(tp["shared_attn"])))
    names = {name for name, _ in tpl.kernels}
    assert {"ssd_scan", "rmsnorm", "flash_attention"} <= names


def test_faas_evict_schedule_matches_jax():
    """The schedule of ``tests/test_runtime.py``'s evict test: an attention
    function (paged pool) and a zamba one (dense pool), served and evicted
    three times; kinds, tokens and pool counts equal the JAX runtime's and
    every free count returns to its start."""
    outs = []
    for api, smoke, make_rt, conv in (
            (jax_api, jax_smoke, lambda **kw: jax_faas.FaaSRuntime(**kw),
             None),
            (torch_api, lambda a, **kw: torch_smoke(a, device="cpu", **kw),
             lambda **kw: FaaSRuntime(device="cpu", **kw), True)):
        m = smoke("smollm-135m", n_layers=1)
        s = smoke(ARCH)
        params = []
        for mod, jm in ((m, jax_smoke("smollm-135m", n_layers=1)),
                        (s, jax_smoke(ARCH))):
            jp = jm.init_params(jax.random.PRNGKey(0))
            params.append(jp if conv is None else convert.params_from_jax(
                jax.tree.map(np.asarray, jp), mod.cfg, device="cpu"))
        rt = make_rt(n_slots=2, max_len=MAX_LEN, trace_seq=8)
        rt.deploy(api.static_function("f-att", m, params[0]), {}, prewarm_seq=8)
        rt.deploy(api.static_function("f-ssm", s, params[1]), {}, prewarm_seq=8)
        prompt = np.arange(6, dtype=np.int32)
        rows = [(r.kind, r.tokens.tolist()) for r in
                (rt.submit("f-att", {}, prompt, 2), rt.submit("f-ssm", {}, prompt, 2))]
        baseline = rt.kv_pool_stats()
        for _ in range(3):
            rows.append([(r.kind, r.tokens.tolist()) for r in
                         (rt.submit("f-att", {}, prompt, 2),
                          rt.submit("f-ssm", {}, prompt, 2))])
            rows.append(rt.evict())
            assert rt.kv_pool_stats() == baseline
        # an engine evicted while it still holds a slot returns it
        _, engine, _, _ = rt._engine_for("f-ssm", {}, time.perf_counter())
        engine.submit(prompt, 4)
        engine.step()
        held = rt.kv_pool_stats()
        rows.append(rt.evict())
        outs.append((rows, sorted(v["n_free_slots"] for v in baseline.values()),
                     sorted(v["n_free_slots"] for v in held.values()),
                     list(rt.kv_pool_stats().values()) == list(baseline.values())))
    assert outs[0] == outs[1]
    assert outs[1][0][0][0] == "cold" and outs[1][0][1][0] == "cold"
    assert outs[1][2] == [1, 2] and outs[1][3]


def test_faas_zamba_kinds_and_refusals(zamba):
    """Cold, warm and fork through the dense pool, the fork's prefill
    streamed and its tokens equal to the warm ones; what needs a paged
    arena raises for zamba, as in the JAX runtime."""
    _, _, tm, tp = zamba
    rt = FaaSRuntime(device="cpu", n_slots=2, max_len=MAX_LEN, trace_seq=8)
    fn = torch_api.static_function("z", tm, tp)
    rt.deploy(fn, {}, prewarm_seq=8)
    prompt = np.arange(7, dtype=np.int32)
    cold = rt.submit("z", {}, prompt, 4)
    warm = rt.submit("z", {}, prompt, 4)
    rt.evict("z")
    fork = rt.submit("z", {}, prompt, 4)
    assert (cold.kind, warm.kind, fork.kind) == ("cold", "warm", "fork")
    assert cold.streamed_prefill and fork.streamed_prefill
    assert not warm.streamed_prefill
    np.testing.assert_array_equal(fork.tokens, warm.tokens)
    np.testing.assert_array_equal(cold.tokens, warm.tokens)
    fs = fork.fork_stats
    assert (fs.reused_bytes + fs.streamed_bytes + fs.dynamic_bytes
            == rt.server.templates["z"].total_bytes)
    with pytest.raises(ValueError, match="template prompts"):
        rt.deploy(fn, {}, template_prompt=np.arange(12, dtype=np.int32))
    with pytest.raises(ValueError, match="runtime prefixes"):
        rt.bake_runtime_prefix("z", np.arange(12, dtype=np.int32))
    with pytest.raises(ValueError, match="adapter banks"):
        rt.deploy_shared_base(torch_api.static_function("zb", tm, tp))


def test_serve_cli_runs_zamba_on_the_cpu():
    """``--arch zamba2-2.7b --device cpu`` serves the smoke zamba through
    the runtime: every service class, LoRA on the shared block's wq."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--functions", "2", "--requests", "6", "--lora",
         "--prompt-len", "16", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=str(root), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "zamba2-2.7b-smoke (4 layers, float32)" in res.stdout
    lines = [l for l in res.stdout.splitlines() if l.startswith("req")]
    assert len(lines) == 6
    assert {l.split()[3] for l in lines} == {"cold", "fork", "warm"}, res.stdout


def test_gateway_keeps_the_dense_pool_exclusive_for_zamba_engines(zamba):
    """Two LoRA events of one zamba function fork two engines over ONE
    dense pool; the gateway lets only the engine holding slots decode
    there, so a batch of invocations across both completes, with the same
    kinds, statuses, tokens and free slots as in the JAX runtime."""
    jm, jp, tm, tp = zamba
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (7, 10, 5)]
    batch = [("zl", {"adapter": "adapter-0"}, prompts[0], 4),
             ("zl", {"adapter": "adapter-1"}, prompts[1], 3),
             ("zl", {"adapter": "adapter-0"}, prompts[2], 5)]
    outs = []
    for api, model, params, make_rt in (
            (jax_api, jm, jp, lambda **kw: jax_faas.FaaSRuntime(**kw)),
            (torch_api, tm, tp, lambda **kw: FaaSRuntime(device="cpu", **kw))):
        rt = make_rt(n_slots=2, max_len=MAX_LEN, trace_seq=8)
        rt.deploy(api.lora_function("zl", model, params, ["shared_attn.attn.wq"],
                                    n_adapters=2),
                  {"adapter": "adapter-0"}, prewarm_seq=8)
        res = rt.submit_many(batch)
        outs.append(([(r.kind, r.status, r.tokens.tolist()) for r in res],
                     len(rt.warm_engines()), list(rt.kv_pool_stats().values())))
    assert outs[0] == outs[1]
    assert outs[1][1] == 2 and outs[1][2] == [{"n_free_slots": 2}]
    assert all(status == "done" for _, status, _ in outs[1][0])
