"""The port's xlstm serving path, held against the JAX package on the CPU.

The smoke xlstm (3 mLSTM blocks and 1 sLSTM block, fp32, weights carried
by ``convert.params_from_jax``) goes through:

* the dense slot pool: slots and free counts on one alloc / write / read /
  release trace, nested state leaves written and read back against the
  JAX pool's; the paged pool refuses the family;
* the sequential ``Engine`` and ``ContinuousBatchingEngine`` (dense pool,
  2 slots) on the mixed request trace of ``tests/test_runtime.py``:
  identical greedy tokens to both JAX engines;
* the layer-streamed prefill of a forked session: ``torch.equal`` to the
  monolithic prefill (logits and every cache leaf), at ``ssm_chunk`` 128
  and 8, ``ValueError`` for a suffix offset;
* the traced weight order: the JAX xlstm order key for key through
  ``convert.jax_key``, unit by unit;
* ``FaaSRuntime``: cold, warm and fork of a static function, the fork's
  tokens equal to the warm ones; template prompts, runtime prefixes and
  shared bases (adapter banks) refused; the gateway keeping the dense
  pool to one engine at a time across two LoRA events (``mlstm.mixer.wq``),
  with the JAX runtime's kinds, statuses, tokens and free slots;
* the serve CLI: ``--arch xlstm-1.3b --device cpu`` serves, ``--lora``
  exits naming the missing GQA projection.
"""

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
                                 FaaSRuntime, KVCachePool, PagedKVCachePool)
from repro_torch.utils import named_leaves  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ARCH = "xlstm-1.3b"
MAX_LEN = 24


def _mixed_requests(vocab, seed=3):
    """The request mix of ``tests/test_runtime.py``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, s).astype(np.int32), n)
            for s, n in [(4, 5), (9, 3), (6, 7), (11, 4), (5, 6)]]


def _pair(**extra):
    jm = jax_smoke(ARCH, **extra)
    tm = torch_smoke(ARCH, device="cpu", **extra)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def xlstm():
    return _pair()


def test_dense_pool_slots_and_nested_leaves_match_jax(xlstm):
    jm, jp, tm, tp = xlstm
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
    arena = dict(named_leaves(tpool.cache))
    for path, leaf in named_leaves(tc):
        g, k = path.split(".")
        assert torch.equal(back[path], leaf), path
        np.testing.assert_allclose(back[path].numpy(), np.asarray(jback[g][k]),
                                   atol=2e-4, rtol=0)
        # an untouched slot keeps the fresh state: EMPTY_M for the mLSTM m
        np.testing.assert_array_equal(arena[path][:, 0].numpy(),
                                      np.asarray(jpool.cache[g][k][:, 0]))
    assert tpool.nbytes() == sum(int(l.nbytes) for l in jax.tree.leaves(jpool.cache))
    with pytest.raises(ValueError, match="paged KV"):
        PagedKVCachePool(tm, n_slots=2, max_len=16)


def test_engine_tokens_match_jax(xlstm):
    jm, jp, tm, tp = xlstm
    prompts = np.random.default_rng(4).integers(0, 256, (2, 16)).astype(np.int32)
    want = JaxEngine(jm, jp, donate_cache=False).generate(
        prompts, max_new_tokens=6).tokens
    got = Engine(tm, tp).generate(prompts, max_new_tokens=6).tokens
    np.testing.assert_array_equal(got, np.asarray(want))


def test_continuous_tokens_match_jax_on_the_mixed_trace(xlstm):
    """Two slots for the five requests (slot reuse, mid-decode admission),
    the dense pool by default, greedy tokens equal to both JAX engines."""
    jm, jp, tm, tp = xlstm
    reqs = _mixed_requests(tm.cfg.vocab_size, seed=1)
    eng = JaxEngine(jm, jp, donate_cache=False)
    want = [eng.generate(p[None], max_new_tokens=n, cache_len=MAX_LEN).tokens[0]
            for p, n in reqs]
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
    tpl = srv.register(torch_api.static_function("x", tm, tp), {})
    return srv, tpl


@pytest.mark.parametrize("chunk,B,S", [(128, 1, 32), (8, 1, 32), (8, 1, 5),
                                       (8, 2, 16)])
def test_streamed_prefill_equals_prefill(chunk, B, S):
    _, _, tm, tp = _pair(ssm_chunk=chunk)
    assert supports_streamed_prefill(tm)
    srv, _ = _register(tm, tp)
    session, stats = srv.fork("x", {})
    toks = np.random.default_rng(5).integers(0, 256, (B, S)).astype(np.int32)
    lg_s, c_s = streamed_prefill(session, {"tokens": toks}, tm.make_cache(B, 40))
    lg_m, c_m = tm.prefill(tp, {"tokens": toks}, tm.make_cache(B, 40))
    assert torch.equal(lg_s, lg_m)
    for (pa, a), (pb, b) in zip(named_leaves(c_s), named_leaves(c_m)):
        assert pa == pb and torch.equal(a, b), pa
    session.streamer.wait_all()
    order = srv.templates["x"].order
    assert session.streamer.completed_order == [
        k for k in order if k in {e.key for e in session.streamer.entries}]
    with pytest.raises(ValueError, match="offset=8"):
        streamed_prefill(session, {"tokens": toks}, tm.make_cache(1, 40), offset=8)


def test_traced_order_matches_jax(xlstm):
    """Unit by unit: the unit's mLSTM blocks, then its sLSTM block (its
    post-MLP last), then the final norm and the head."""
    jm, _, tm, tp = xlstm
    _, tpl = _register(tm, tp)
    specs = jm.init_params(abstract=True)
    jtr = jax_trace(lambda p, i, c: jm.prefill(p, i, c), specs,
                    jm.input_specs("prefill", 1, 16, dtype=jnp.float32),
                    jm.make_cache(1, 16, abstract=True))
    assert [convert.jax_key(p) for p, _ in tpl.order] == jtr.order
    groups = [p.split(".")[0] for p, _ in tpl.order]
    first_s = groups.index("slstm")
    assert set(groups[:first_s]) == {"embed", "mlstm"}
    assert len(tpl.order) == len(list(named_leaves(tp)))
    names = {name for name, _ in tpl.kernels}
    assert "rmsnorm" in names
    assert not names & {"ssd_scan", "flash_attention", "decode_attention",
                        "paged_decode_attention"}


def test_faas_xlstm_kinds_and_refusals(xlstm):
    """Cold, warm and fork through the dense pool, the fork's prefill
    streamed and its tokens equal to the warm ones; what needs a paged
    arena or an adapter bank raises for xlstm, as in the JAX runtime."""
    _, _, tm, tp = xlstm
    rt = FaaSRuntime(device="cpu", n_slots=2, max_len=MAX_LEN, trace_seq=8)
    fn = torch_api.static_function("x", tm, tp)
    rt.deploy(fn, {}, prewarm_seq=8)
    prompt = np.arange(7, dtype=np.int32)
    cold = rt.submit("x", {}, prompt, 4)
    warm = rt.submit("x", {}, prompt, 4)
    rt.evict("x")
    fork = rt.submit("x", {}, prompt, 4)
    assert (cold.kind, warm.kind, fork.kind) == ("cold", "warm", "fork")
    assert cold.streamed_prefill and fork.streamed_prefill
    assert not warm.streamed_prefill
    np.testing.assert_array_equal(fork.tokens, warm.tokens)
    np.testing.assert_array_equal(cold.tokens, warm.tokens)
    fs = fork.fork_stats
    assert (fs.reused_bytes + fs.streamed_bytes + fs.dynamic_bytes
            == rt.server.templates["x"].total_bytes)
    assert list(rt.kv_pool_stats().values()) == [{"n_free_slots": 2}]
    with pytest.raises(ValueError, match="template prompts"):
        rt.deploy(fn, {}, template_prompt=np.arange(12, dtype=np.int32))
    with pytest.raises(ValueError, match="runtime prefixes"):
        rt.bake_runtime_prefix("x", np.arange(12, dtype=np.int32))
    with pytest.raises(ValueError, match="adapter banks"):
        rt.deploy_shared_base(torch_api.static_function("xb", tm, tp))


def test_gateway_keeps_the_dense_pool_exclusive_for_xlstm_engines(xlstm):
    """Two LoRA events of one xlstm function fork two engines over ONE
    dense pool; the gateway lets only the engine holding slots decode
    there, so a batch of invocations across both completes, with the same
    kinds, statuses, tokens and free slots as in the JAX runtime."""
    jm, jp, tm, tp = xlstm
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (7, 10, 5)]
    batch = [("xl", {"adapter": "adapter-0"}, prompts[0], 4),
             ("xl", {"adapter": "adapter-1"}, prompts[1], 3),
             ("xl", {"adapter": "adapter-0"}, prompts[2], 5)]
    outs = []
    for api, model, params, make_rt in (
            (jax_api, jm, jp, lambda **kw: jax_faas.FaaSRuntime(**kw)),
            (torch_api, tm, tp, lambda **kw: FaaSRuntime(device="cpu", **kw))):
        rt = make_rt(n_slots=2, max_len=MAX_LEN, trace_seq=8)
        rt.deploy(api.lora_function("xl", model, params, ["mlstm.mixer.wq"],
                                    n_adapters=2),
                  {"adapter": "adapter-0"}, prewarm_seq=8)
        res = rt.submit_many(batch)
        outs.append(([(r.kind, r.status, r.tokens.tolist()) for r in res],
                     len(rt.warm_engines()), list(rt.kv_pool_stats().values())))
    assert outs[0] == outs[1]
    assert outs[1][1] == 2 and outs[1][2] == [{"n_free_slots": 2}]
    assert all(status == "done" for _, status, _ in outs[1][0])


def test_serve_cli_runs_xlstm_on_the_cpu():
    """``--arch xlstm-1.3b --device cpu`` serves the smoke xlstm through
    the runtime (cold, then warm); ``--lora`` exits naming the GQA
    projection xlstm does not have."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
            "--device", "cpu", "--prompt-len", "16", "--max-new", "4"]
    res = subprocess.run(base + ["--functions", "2", "--requests", "5"],
                         capture_output=True, text=True, env=env,
                         cwd=str(root), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "xlstm-1.3b-smoke (4 layers, float32)" in res.stdout
    lines = [l for l in res.stdout.splitlines() if l.startswith("req")]
    assert len(lines) == 5
    assert {l.split()[2] for l in lines} == {"cold", "warm"}, res.stdout
    res = subprocess.run(base + ["--lora"], capture_output=True, text=True,
                         env=env, cwd=str(root), timeout=300)
    assert res.returncode != 0
    assert "blocks.attn.wq" in res.stderr and "no attention" in res.stderr
