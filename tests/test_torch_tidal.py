"""The port's TIDAL core, held against the JAX package on the CPU.

Tracing (a ``TorchDispatchMode`` over ``meta`` parameters) gives the JAX
jaxpr walk's access order key for key once port names are mapped through
``convert.jax_key``; LoRA functions mark the same weights dynamic and
merge the same weights; templates keep the same resident set under one
Eq. 1 budget; ``streamed_prefill`` equals the port's monolithic prefill
exactly (``torch.equal``) and the JAX prefill within 2e-4; the streamer
follows the template's order and surfaces a ``weight_fetch`` fault to
every waiter; the forking guard sees template buffers untouched and
flags a write to one middle row of a shared buffer.  The
dense cases of tests/test_streaming.py, tests/test_tracing.py and
tests/test_template.py are mirrored.  Smoke configs, fp32.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import api as jax_api  # noqa: E402
from repro.core.template_server import TemplateServer as JaxServer  # noqa: E402
from repro.core.tracing import trace_weight_access as jax_trace  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tidal  # noqa: E402
from repro_torch.core.forking import DonationGuard, copy_for_write  # noqa: E402
from repro_torch.core.merging import (MergedHostBuffer, plan_groups,  # noqa: E402
                                      validate_plan)
from repro_torch.core.streaming import (ForkSession, StreamEntry,  # noqa: E402
                                        WeightStreamer, streamed_prefill)
from repro_torch.core.template import prefetch_bytes  # noqa: E402
from repro_torch.core.template_server import TemplateServer  # noqa: E402
from repro_torch.core.tracing import (coverage, trace_weight_access,  # noqa: E402
                                      weight_sizes)
from repro_torch.hw import H100_SXM  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402
from repro_torch.runtime import FaultPlan, FaultSpec, use_fault_plan  # noqa: E402
from repro_torch.runtime.errors import WeightFetchFault  # noqa: E402
from repro_torch.utils import named_leaves, tree_bytes  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
ARCHS = ["smollm-135m", "qwen3-14b", "qwen2.5-32b", "gemma-2b", "llama3-8b",
         "llama2-13b", "chameleon-34b", "llama2-70b", "whisper-medium"]


def _port_trace(model, B=2, S=16):
    """The model's prefill traced over its ``meta`` input specs (enc-dec:
    frames and tokens), as ``TemplateServer.register`` traces it."""
    specs = model.param_specs()
    inputs = model.input_specs("prefill", B, S)
    cache = model.make_cache(B, S, device="meta")
    return specs, trace_weight_access(
        lambda p, i, c: model.prefill(p, i, c), specs, inputs, cache)


@pytest.fixture(scope="module")
def smol():
    """A 4-layer smoke smollm with JAX weights carried into the port, and a
    template server holding it as a static function."""
    jm = jax_smoke("smollm-135m", n_layers=4)
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=4)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    srv = TemplateServer(trace_batch=2, trace_seq=16)
    srv.register(tidal.static_function("smol", tm, tp), {})
    return jm, jp, tm, tp, srv


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_trace_order_equals_the_jaxpr_walk(arch):
    jm = jax_smoke(arch, n_layers=2)
    tm = torch_smoke(arch, device="cpu", n_layers=2)
    want = jax_trace(lambda p, i, c: jm.prefill(p, i, c),
                     jm.init_params(abstract=True),
                     jm.input_specs("prefill", 2, 16, dtype=jnp.float32),
                     jm.make_cache(2, 16, abstract=True)).order
    specs, tr = _port_trace(tm)
    assert [convert.jax_key(p) for p, _ in tr.order] == want
    assert not coverage(specs, tr)[1]


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma-2b"])
def test_traced_bytes_and_tied_embedding_first(arch):
    """Access-ordered weights partition the params exactly, and a tied
    embedding is accessed first (the paper's Fig. 20 case)."""
    tm = torch_smoke(arch, device="cpu", n_layers=2)
    specs, tr = _port_trace(tm)
    assert sum(weight_sizes(specs, tr.order).values()) == tree_bytes(specs)
    assert len(set(tr.order)) == len(tr.order)
    assert tr.order[0] == ("embed", ())
    assert not any(k[0] == "lm_head" for k in tr.order)
    # tracing ran on meta tensors: no storage was touched
    assert all(t.device.type == "meta" for _, t in named_leaves(specs))


def test_kernel_set_is_one_block_body():
    """Deduped signatures do not grow with depth; launches do.  The
    hand-written kernels enter under their own names."""
    _, tr2 = _port_trace(torch_smoke("smollm-135m", device="cpu", n_layers=2))
    _, tr4 = _port_trace(torch_smoke("smollm-135m", device="cpu", n_layers=4))
    assert len(tr4.kernels) == len(tr2.kernels)
    assert tr4.kernel_launches > tr2.kernel_launches
    names = {name for name, _ in tr2.kernels}
    assert "flash_attention" in names and "mm" in names


def test_order_is_shape_independent_and_decode_covers_params():
    tm = torch_smoke("qwen3-14b", device="cpu", n_layers=2)
    assert _port_trace(tm, 1, 16)[1].order == _port_trace(tm, 1, 64)[1].order
    specs = tm.param_specs()
    cache = transformer.make_cache(tm.cfg, 2, 32, device="meta")
    tr = trace_weight_access(
        lambda p, c, t: transformer.decode_step(p, tm.cfg, c, t, 5), specs,
        cache, torch.zeros((2, 1), dtype=torch.int32, device="meta"))
    assert not coverage(specs, tr)[1]
    assert "decode_attention" in {name for name, _ in tr.kernels}


# ---------------------------------------------------------------------------
# LoRA functions and templates
# ---------------------------------------------------------------------------

def test_lora_function_matches_jax_dynamic_paths_and_merged_weights():
    jm = jax_smoke("smollm-135m", n_layers=2)
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=2)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    jfn = jax_api.lora_function("f", jm, jp, ["blocks.attn.wq"], n_adapters=3)
    tfn = tidal.lora_function("f", tm, tp, ["blocks.attn.wq"], n_adapters=3)
    jsrv, tsrv = JaxServer(trace_seq=16), TemplateServer(trace_seq=16)
    jt = jsrv.register(jfn, {"adapter": "adapter-0"})
    tt = tsrv.register(tfn, {"adapter": "adapter-0"})
    assert jt.dynamic == set() and tt.dynamic == set()
    _, jst = jsrv.fork("f", {"adapter": "adapter-1"})
    tsess, tst = tsrv.fork("f", {"adapter": "adapter-1"})
    assert jst.new_dynamic == ("blocks.attn.wq",)
    assert tst.new_dynamic == tuple(convert.port_names("blocks.attn.wq", 2))
    assert tst.dynamic_bytes == jst.dynamic_bytes
    jtraced, _ = jfn.run_initializer({"adapter": "adapter-2"})
    ttraced, _ = tfn.run_initializer({"adapter": "adapter-2"})
    jwq = jtraced["blocks"]["attn"]["wq"].materialize()
    for i in range(2):
        np.testing.assert_allclose(
            ttraced["layers"][i]["attn"]["wq"].materialize().numpy(), jwq[i],
            atol=1e-6, rtol=0)
    # dynamic weights differ across events; static ones are identical
    s2, _ = tsrv.fork("f", {"adapter": "adapter-2"})
    p1, p2 = tsess.params(), s2.params()
    assert not torch.equal(p1["layers"][0]["attn"]["wq"],
                           p2["layers"][0]["attn"]["wq"])
    assert torch.equal(p1["embed"], p2["embed"])


def test_template_resident_set_matches_jax_under_one_budget():
    jm = jax_smoke("smollm-135m", n_layers=2)
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=2)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    jt = JaxServer(trace_seq=16).register(jax_api.static_function("f", jm, jp), {})
    tt = TemplateServer(trace_seq=16).register(tidal.static_function("f", tm, tp), {})
    assert tt.total_bytes == jt.total_bytes
    for budget in (0, jt.total_bytes // 3, jt.total_bytes // 2, jt.total_bytes):
        jt.resident_bytes = tt.resident_bytes = budget
        assert ({convert.jax_key(k[0]) for k in tt.resident_set()}
                == jt.resident_set())
    # Eq. 1 feedback gives the same budget for the same TTFT and rate
    hw = H100_SXM.with_h2d(1e6)
    tt.observe_ttft(0.05, hw)
    assert tt.resident_bytes == prefetch_bytes(tt.total_bytes, 0.05, hw)


def test_template_policy_mirrors_jax():
    """Eq. 1 clamps, dynamic weights are never resident, exclusion is
    incremental, merge plans keep the access order (tests/test_template.py)."""
    assert prefetch_bytes(10 << 30, 1000.0, H100_SXM) == 0
    assert prefetch_bytes(10 << 30, 0.0, H100_SXM) == 10 << 30
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=1)
    tt = TemplateServer(trace_seq=8).register(
        tidal.static_function("f", tm, tm.init_params()), {})
    first = tt.order[0]
    tt.dynamic = {first[0]}
    tt.resident_bytes = tt.sizes[tt.order[1]]
    assert tt.resident_set() == {tt.order[1]}
    fps = dict(tt.fingerprints)
    fps[tt.order[2][0]] = ("load", "OTHER")
    assert tt.observe_init(fps) == {tt.order[2][0]}
    assert tt.observe_init(fps) == set()
    order = [(f"w{i}", ()) for i in range(40)]
    sizes = {k: 10 + i for i, k in enumerate(order)}
    groups = plan_groups(order, sizes, max_groups=7)
    validate_plan(order, sizes, groups)
    assert len(groups) <= 7
    a, b = torch.arange(12.0).reshape(3, 4), torch.arange(6, dtype=torch.int32)
    sizes = {("a", ()): 48, ("b", ()): 24}
    (g,) = plan_groups(list(sizes), sizes, max_groups=1)
    buf = MergedHostBuffer(g)
    buf.write(("a", ()), a)
    buf.write(("b", ()), b)
    assert torch.equal(buf.read(("a", ())), a) and torch.equal(buf.read(("b", ())), b)


# ---------------------------------------------------------------------------
# forking and streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 8])
def test_streamed_prefill_exact(smol, offset):
    """Layer-streamed prefill equals the port's monolithic prefill bit for
    bit (and the JAX prefill within 2e-4), whole prompt or suffix."""
    jm, jp, tm, tp, srv = smol
    sess, _ = srv.fork("smol", {})
    toks = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32)
    pre = tm.make_cache(2, 32)
    if offset:
        tm.prefill(tp, {"tokens": toks[:, :offset]}, pre)
    base = {k: v.clone() for k, v in pre.items()}
    lg_s, cache_s = streamed_prefill(sess, {"tokens": toks[:, offset:]}, pre,
                                     offset=offset)
    lg_r, cache_r = tm.prefill_from(tp, {"tokens": toks[:, offset:]}, base,
                                    offset)
    assert torch.equal(lg_s, lg_r)
    for k in cache_s:
        assert torch.equal(cache_s[k], cache_r[k])
    lg_j, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.make_cache(2, 32))
    np.testing.assert_allclose(lg_s.numpy(), np.asarray(lg_j), atol=2e-4, rtol=0)


def test_streaming_follows_traced_order(smol):
    *_, srv = smol
    sess, _ = srv.fork("smol", {})
    sess.streamer.wait_all()
    expect = [k for k in srv.templates["smol"].static_order
              if k[0] not in sess.streamer.resident]
    assert sess.streamer.completed_order == expect


def test_fork_shares_resident_buffers_and_guard_sees_them_untouched(smol):
    jm, jp, tm, tp, srv = smol
    srv.set_resident_bytes("smol", srv.templates["smol"].total_bytes // 2)
    s1, st1 = srv.fork("smol", {})
    s2, st2 = srv.fork("smol", {})
    assert st1.reused_bytes > 0 and st1.streamed_bytes > 0
    assert st1.reused_bytes + st1.streamed_bytes + st1.dynamic_bytes == \
        srv.templates["smol"].total_bytes
    assert s1.leaf("embed") is s2.leaf("embed")          # the same buffer
    guard = DonationGuard.guard(dict(srv.device_cache["smol"]))
    p = s1.params()
    toks = np.random.default_rng(2).integers(0, 256, (2, 16)).astype(np.int32)
    cache = tm.make_cache(2, 32)
    lg, cache = tm.prefill(p, {"tokens": toks}, cache)
    for pos in range(16, 20):
        lg, cache = tm.decode_step(p, cache, {"tokens": np.zeros((2, 1), np.int32)},
                                   pos)
    assert guard.check(dict(srv.device_cache["smol"])) == []
    # an in-place write to a shared buffer is exactly what the guard catches
    private = copy_for_write(p["embed"])
    private.add_(1.0)
    assert guard.check(dict(srv.device_cache["smol"])) == []
    p["embed"].add_(1.0)
    assert guard.check(dict(srv.device_cache["smol"])) == ["embed"]
    p["embed"].sub_(1.0)
    srv.set_resident_bytes("smol", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_guard_sees_a_write_to_one_middle_row(dtype):
    g = torch.Generator().manual_seed(0)
    bufs = {"wq": torch.randn(1000, 64, generator=g).to(dtype),
            "wo": torch.randn(64, 1000, generator=g).to(dtype)}
    guard = DonationGuard.guard(bufs)
    assert guard.check(bufs) == []
    row = bufs["wq"][517].clone()
    bufs["wq"][517, 3:9] += 1.0                # part of one middle row
    assert guard.check(bufs) == ["wq"]
    bufs["wq"][517] = row
    bufs["wo"][:, 333].mul_(-1.0)              # one column, sign flipped
    assert guard.check(bufs) == ["wo"]


def test_eq1_feedback_loop(smol):
    *_, srv = smol
    srv.observe_ttft("smol", 1e-9)
    assert len(srv.device_cache["smol"]) > 0
    srv.set_resident_bytes("smol", 0)
    assert len(srv.device_cache["smol"]) == 0


def test_weight_fetch_fault_surfaces_to_every_waiter():
    """An injected ``weight_fetch`` fault past the retry budget reaches
    every blocked consumer and ``wait_all``; weights that landed before it
    stay servable.  A transient one is retried away."""
    ok = torch.ones(4)
    entries = [StreamEntry((n, ()), fetch=lambda: ok) for n in "abc"]
    plan = FaultPlan([FaultSpec("weight_fetch", at=0, times=3, match="b:")])
    with use_fault_plan(plan):
        ws = WeightStreamer(entries, {}, {}, retry_backoff_s=0.001)
        got = {}

        def consumer():
            try:
                got["c"] = ws.get(("c", ()))
            except BaseException as e:            # noqa: BLE001
                got["c"] = e

        t = threading.Thread(target=consumer)
        t.start()
        ws.start()
        t.join(timeout=10.0)
    assert not t.is_alive(), "blocked consumer hung after stream failure"
    assert isinstance(got["c"], WeightFetchFault)
    assert torch.equal(ws.get(("a", ())), ok)
    with pytest.raises(WeightFetchFault):
        ws.get(("b", ()))
    with pytest.raises(WeightFetchFault):
        ws.wait_all()
    assert ws.retries_used == 2
    with use_fault_plan(FaultPlan([FaultSpec("weight_fetch", at=0)])):
        ws2 = WeightStreamer(entries[:1], {}, {}, retry_backoff_s=0.001).start()
        ws2.wait_all()
    assert ws2.retries_used == 1 and torch.equal(ws2.get(("a", ())), ok)


def test_fork_session_params_surfaces_stream_error():
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=1)
    flat = dict(named_leaves(tm.init_params()))

    def bad():
        time.sleep(0.01)
        raise IOError("checkpoint shard unreachable")

    entries = [StreamEntry((p, ()), fetch=bad if i == 1 else (lambda t=t: t))
               for i, (p, t) in enumerate(flat.items())]
    session = ForkSession(tm, WeightStreamer(entries, {}, {}).start())
    with pytest.raises(IOError, match="shard unreachable"):
        session.params()


def test_process_pool_defaults_to_the_card():
    """The prewarm pool, like every entry point of the port, targets the
    card unless the caller passes ``device="cpu"``; without a card the
    default raises when the first worker warms its context.  (The JAX pool
    has no device argument: it warms the default JAX backend.)"""
    from repro.core.prewarm import ExecutableCache as JaxCache
    from repro.core.prewarm import ProcessPool as JaxPool
    from repro_torch.core.prewarm import ExecutableCache, ProcessPool, Worker

    pool = ProcessPool(2, ExecutableCache(), device="cpu")
    want = JaxPool(size=2, cache=JaxCache())
    assert [w.worker_id for w in pool.workers] == [w.worker_id for w in want.workers]
    assert all(w.device.type == "cpu" and w.ctx_ready for w in pool.workers)
    assert Worker(0).device.type == "cuda"
    if torch.cuda.is_available():
        assert all(w.device.type == "cuda"
                   for w in ProcessPool(2, ExecutableCache()).workers)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ProcessPool(2, ExecutableCache())
