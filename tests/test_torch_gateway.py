"""The port's gateway under faults and pressure, held against the JAX one.

Each case runs one schedule (requests, a ``FaultPlan``, cancels,
deadlines, pressure limits) against both packages' ``FaaSRuntime`` on the
same weights (smoke smollm, 2 layers, fp32, carried by
``convert.params_from_jax``) and asserts identical outcomes: statuses,
retry counts, tokens, gateway stats, failure-log invariants and pool
counts.  Mirrored from tests/test_faults.py: crash recovery with
bit-identical replay, an exhausted retry budget, a crash between prefill
chunks over a borrowed prefix, a crash during admission, cancel while
awaiting retry, a fatal pump-thread error, overload rejection with
priority shed, and brown-out.  From tests/test_gateway.py: streaming
handles, cancel of a pinned-prefix borrower, cancel of a queued request,
deadline shed, an unservable request failing alone and drain mode across
an evicted engine.  The adapter-load fault is held against the JAX one in
tests/test_torch_adapters.py, the control plane's hooks in
tests/test_torch_controlplane.py; the mesh cases wait for their slice.
"""

import time
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.api as jax_api  # noqa: E402
import repro.runtime.errors as jax_errors  # noqa: E402
import repro.runtime.faas as jax_faas  # noqa: E402
import repro.runtime.faults as jax_faults  # noqa: E402
import repro.runtime.gateway as jax_gateway  # noqa: E402
import repro_torch.core.api as torch_api  # noqa: E402
import repro_torch.runtime.errors as torch_errors  # noqa: E402
import repro_torch.runtime.faas as torch_faas  # noqa: E402
import repro_torch.runtime.faults as torch_faults  # noqa: E402
import repro_torch.runtime.gateway as torch_gateway  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402

MAX_LEN = 32


def _pkg(api, errors, faas, faults, gateway, model, params, **rt_kw):
    return types.SimpleNamespace(
        api=api, errors=errors, faults=faults, model=model, params=params,
        Request=gateway.InvocationRequest,
        runtime=lambda **kw: faas.FaaSRuntime(**rt_kw, **kw))


@pytest.fixture(scope="module")
def pkgs():
    """The JAX and the port side, each with two seeded weight sets."""
    jm = jax_smoke("smollm-135m", n_layers=2)
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=2)
    jps = [jm.init_params(jax.random.PRNGKey(s)) for s in (0, 1)]
    tps = [convert.params_from_jax(jax.tree.map(np.asarray, p), tm.cfg,
                                   device="cpu") for p in jps]
    return [_pkg(jax_api, jax_errors, jax_faas, jax_faults, jax_gateway,
                 jm, jps),
            _pkg(torch_api, torch_errors, torch_faas, torch_faults,
                 torch_gateway, tm, tps, device="cpu")]


def _both(pkgs, scenario):
    """Run ``scenario(P)`` on each package; the outcomes must match."""
    outs = [scenario(P) for P in pkgs]
    assert outs[0] == outs[1]
    return outs[1]


def _rt(P, fns=("fn-a", "fn-b"), template=None, **kw):
    kw.setdefault("n_slots", 2)
    rt = P.runtime(max_len=kw.pop("max_len", MAX_LEN), trace_seq=8,
                   page_size=4, prewarm=False, **kw)
    for i, name in enumerate(fns):
        rt.deploy(P.api.static_function(name, P.model, P.params[i]), {},
                  template_prompt=template if i == 0 else None)
    return rt


def _prompts(n, lens=(8, 7, 6), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, lens[i % len(lens)]).astype(np.int32)
            for i in range(n)]


def _res(r):
    return (r.status, r.kind, r.retries, [int(t) for t in r.tokens])


def _failures(rt):
    out = []
    for e in rt.gateway.failures:
        out.append({k: v for k, v in e.items() if k != "error"})
    return out


# ---------------------------------------------------------------------------
# crash supervision (tests/test_faults.py)
# ---------------------------------------------------------------------------

def test_crash_recovery_replays_bit_identical(pkgs):
    pa, pb = _prompts(2)

    def run(P):
        rt = _rt(P)
        rt.submit("fn-a", {}, pa, 2)
        rt.submit("fn-b", {}, pb, 2)
        baseline = rt.kv_pool_stats()
        plan = P.faults.FaultPlan([P.faults.FaultSpec("engine_step", at=2,
                                                      match="fn-a@")])
        with P.faults.use_fault_plan(plan):
            ha = rt.submit(P.Request("fn-a", pa, max_new_tokens=6))
            hb = rt.submit(P.Request("fn-b", pb, max_new_tokens=6))
            ra, rb = ha.result(), hb.result()
        assert list(rt.kv_pool_stats().values()) == list(baseline.values())
        return (_res(ra), _res(rb), dict(rt.gateway.stats), _failures(rt),
                [f["point"] for f in plan.fired])

    out = _both(pkgs, run)
    assert out[0][2] == 1 and out[1][2] == 0
    assert out[3][0]["cotenants_intact"] and out[3][0]["victim_mapped_pages"] > 0


def test_retry_budget_exhausted_is_typed_failure(pkgs):
    pa, pb = _prompts(2, seed=1)

    def run(P):
        rt = _rt(P)
        rt.submit("fn-a", {}, pa, 2)
        rt.submit("fn-b", {}, pb, 2)
        plan = P.faults.FaultPlan([P.faults.FaultSpec("engine_step", at=1,
                                                      match="fn-a@")])
        with P.faults.use_fault_plan(plan):
            ha = rt.submit(P.Request("fn-a", pa, max_new_tokens=6,
                                     max_retries=0))
            hb = rt.submit(P.Request("fn-b", pb, max_new_tokens=5))
            with pytest.raises(P.errors.EngineFailure, match="retry budget"):
                ha.result()
            rb = hb.result()
        assert isinstance(ha._error.__cause__, P.errors.EngineStepFault)
        return ha.status, _res(rb), dict(rt.gateway.stats), _failures(rt)

    assert _both(pkgs, run)[0] == "failed"


def test_crash_mid_chunked_prefill_partition_safe(pkgs):
    rng = np.random.default_rng(2)
    template = rng.integers(0, 256, 12).astype(np.int32)
    borrower = np.concatenate([template, rng.integers(0, 256, 16).astype(np.int32)])
    other = rng.integers(0, 256, 6).astype(np.int32)

    def run(P):
        rt = _rt(P, template=template, max_len=48, chunk_tokens=8)
        handle = rt._prefix_handles[("fn-a", 0, ())]
        pool = next(iter(rt._pools.values()))
        baseline = rt.kv_pool_stats()
        plan = P.faults.FaultPlan([P.faults.FaultSpec("prefill_chunk", at=1,
                                                      match="chunk:")])
        with P.faults.use_fault_plan(plan):
            ha = rt.submit(P.Request("fn-a", borrower, max_new_tokens=6))
            hb = rt.submit(P.Request("fn-b", other, max_new_tokens=6))
            ra, rb = ha.result(), hb.result()
        assert list(rt.kv_pool_stats().values()) == list(baseline.values())
        return (_res(ra), _res(rb), _failures(rt), ra.reused_prefix_len,
                pool.prefix_page_refs(handle), [f["detail"] for f in plan.fired])

    out = _both(pkgs, run)
    assert out[0][2] == 1 and out[4] == [1, 1, 1]


def test_crash_during_admission_is_retried(pkgs):
    (p,) = _prompts(1, seed=3)

    def run(P):
        rt = _rt(P, fns=("fn",))
        rt.submit("fn", {}, p, 2)
        plan = P.faults.FaultPlan([P.faults.FaultSpec("prefill_chunk", at=0,
                                                      match="admit:")])
        with P.faults.use_fault_plan(plan):
            res = rt.submit(P.Request("fn", p, max_new_tokens=5)).result()
        return _res(res), _failures(rt), list(rt.kv_pool_stats().values())

    assert _both(pkgs, run)[0][2] == 1


def test_cancel_while_awaiting_retry(pkgs):
    (p,) = _prompts(1, seed=4)

    def run(P):
        rt = _rt(P, fns=("fn",), retry_backoff_s=30.0)
        rt.submit("fn", {}, p, 2)
        baseline = rt.kv_pool_stats()
        plan = P.faults.FaultPlan([P.faults.FaultSpec("engine_step", at=1,
                                                      match="fn@")])
        with P.faults.use_fault_plan(plan):
            h = rt.submit(P.Request("fn", p, max_new_tokens=6))
            deadline = time.monotonic() + 60.0
            while (rt.gateway.stats["engine_failures"] == 0
                   and time.monotonic() < deadline):
                rt.gateway.pump(timeout=0.05)
            parked = h.engine is None and not h.done
            cancelled = h.cancel()
        assert list(rt.kv_pool_stats().values()) == list(baseline.values())
        return parked, cancelled, h.status, rt.gateway._retry, \
            h.result().status

    assert _both(pkgs, run) == (True, True, "cancelled", [], "cancelled")


def test_pump_thread_fatal_error_fails_open_handles(pkgs):
    (p,) = _prompts(1, seed=5)

    def run(P):
        rt = _rt(P, fns=("fn",))
        rt.submit("fn", {}, p, 2)
        boom = ValueError("scheduler invariant violated")

        def bad_round():
            raise boom

        rt.gateway._round = bad_round
        rt.gateway.start_pump()
        try:
            h = rt.submit(P.Request("fn", p, max_new_tokens=4))
            with pytest.raises(P.errors.EngineFailure,
                               match="pump thread crashed"):
                h.result(timeout=30.0)
        finally:
            rt.gateway.stop_pump()
        assert h._error.__cause__ is boom
        rt.gateway.stop_pump()                         # idempotent
        return h.status, rt.gateway._pump_thread

    assert _both(pkgs, run) == ("failed", None)


# ---------------------------------------------------------------------------
# graceful degradation
# ---------------------------------------------------------------------------

def test_overload_rejection_and_priority_shed(pkgs):
    prompts = _prompts(3, lens=(6,), seed=6)

    def run(P):
        rt = _rt(P, fns=("fn",), max_live=1)
        rt.submit("fn", {}, prompts[0], 2)
        ha = rt.submit(P.Request("fn", prompts[0], max_new_tokens=4))
        with pytest.raises(P.errors.Overloaded, match="max_live"):
            rt.submit(P.Request("fn", prompts[1], max_new_tokens=4))
        hc = rt.submit(P.Request("fn", prompts[2], max_new_tokens=4,
                                 priority=5))
        with pytest.raises(P.errors.Overloaded, match="shed"):
            ha.result()
        return ha.status, _res(hc.result()), dict(rt.gateway.stats)

    out = _both(pkgs, run)
    assert out[2]["overload_rejections"] == 1 and out[2]["pressure_sheds"] == 1


def test_brownout_clamps_decode_budget(pkgs):
    p1, p2 = _prompts(2, lens=(6, 7), seed=7)

    def run(P):
        rt = _rt(P, fns=("fn",), max_live=4, brownout_threshold=0.5,
                 brownout_max_new=2)
        rt.submit("fn", {}, p1, 2)
        h1 = rt.submit(P.Request("fn", p1, max_new_tokens=8))
        h2 = rt.submit(P.Request("fn", p2, max_new_tokens=8))
        active = rt.gateway.brownout_active()
        r1, r2 = h1.result(), h2.result()
        return (h1.browned_out, h2.browned_out, active, _res(r1), _res(r2),
                rt.gateway.brownout_active())

    out = _both(pkgs, run)
    assert out[:3] == (False, True, True) and len(out[4][3]) == 2


# ---------------------------------------------------------------------------
# lifecycle (tests/test_gateway.py)
# ---------------------------------------------------------------------------

def test_handle_streams_tokens_incrementally(pkgs):
    prompt = np.arange(8, dtype=np.int32)

    def run(P):
        rt = _rt(P, fns=("fn",), gateway_quantum=1)
        h = rt.submit(P.Request("fn", prompt, max_new_tokens=12))
        queued = h.status
        it = h.tokens()
        first = next(it)
        mid = (h.status, h.done)
        rest = list(it)
        assert [first] + rest == [int(t) for t in h.result().tokens]
        return queued, mid, h.status, [first] + rest

    assert _both(pkgs, run)[:3] == ("queued", ("streaming", False), "done")


def test_cancel_borrower_of_a_pinned_prefix_returns_every_page(pkgs):
    rng = np.random.default_rng(0)
    template = rng.integers(0, 256, 12).astype(np.int32)
    borrower = np.concatenate([template, rng.integers(0, 256, 6).astype(np.int32)])
    other = rng.integers(0, 256, 9).astype(np.int32)

    def run(P):
        rt = _rt(P, fns=("fn",), template=template)
        handle = rt._prefix_handles[("fn", 0, ())]
        pool = next(iter(rt._pools.values()))
        baseline = rt.kv_pool_stats()
        hb = rt.submit(P.Request("fn", borrower, max_new_tokens=10))
        ho = rt.submit(P.Request("fn", other, max_new_tokens=4))
        next(hb.tokens())
        refs_mid = pool.prefix_page_refs(handle)
        out = (refs_mid, hb.cancel(), hb.status, hb.cancel(),
               _res(ho.result()), pool.prefix_page_refs(handle),
               hb.result().status, len(hb.result().tokens) >= 1)
        assert list(rt.kv_pool_stats().values()) == list(baseline.values())
        return out

    out = _both(pkgs, run)
    assert out[0][0] == 2 and out[1:4] == (True, "cancelled", False)


def test_cancel_queued_and_deadline_shed(pkgs):
    """A queued request cancels with no tokens; a queued one past its
    deadline is shed typed before prefill and the one behind it serves."""
    long_p, ok_p = _prompts(2, lens=(8, 7), seed=1)

    def run(P):
        rt = _rt(P, fns=("fn",), n_slots=1)
        h1 = rt.submit(P.Request("fn", long_p, max_new_tokens=10))
        next(h1.tokens())
        h2 = rt.submit(P.Request("fn", long_p, max_new_tokens=4))
        cancelled = (h2.status, h2.cancel(), h2.status,
                     len(h2.result().tokens))
        h_shed = rt.submit(P.Request("fn", long_p, max_new_tokens=4,
                                     deadline_s=1e-4))
        h_ok = rt.submit(P.Request("fn", ok_p, max_new_tokens=3))
        time.sleep(0.005)
        res_ok = h_ok.result()
        with pytest.raises(P.errors.DeadlineExceeded):
            h_shed.result()
        with pytest.raises(P.errors.DeadlineExceeded):
            list(h_shed.tokens())
        return (cancelled, h_shed.status, _res(res_ok), _res(h1.result()),
                list(rt.kv_pool_stats().values()))

    out = _both(pkgs, run)
    assert out[0] == ("queued", True, "cancelled", 0) and out[1] == "shed"


def test_unservable_request_fails_alone(pkgs):
    rng = np.random.default_rng(0)
    template = rng.integers(0, 256, 12).astype(np.int32)
    good = np.concatenate([template, rng.integers(0, 256, 8).astype(np.int32)])
    doomed = rng.integers(0, 256, 28).astype(np.int32)

    def run(P):
        rt = _rt(P, fns=("fn",), template=template, n_slots=1)
        h1 = rt.submit(P.Request("fn", good, max_new_tokens=4))
        h2 = rt.submit(P.Request("fn", doomed, max_new_tokens=4))
        h3 = rt.submit(P.Request("fn", good, max_new_tokens=3))
        r1, r3 = h1.result(), h3.result()
        with pytest.raises(P.errors.PoolExhausted, match="pinned prefix"):
            h2.result()
        return _res(r1), _res(r3), h2.status

    assert _both(pkgs, run)[2] == "failed"


def test_drain_mode_serves_across_evicted_engines(pkgs):
    p = np.arange(8, dtype=np.int32)

    def run(P):
        rt = _rt(P)
        rt.gateway.interleave = False
        ha = rt.submit(P.Request("fn-a", p, max_new_tokens=4))
        hb = rt.submit(P.Request("fn-b", p, max_new_tokens=4))
        rt.evict("fn-a")
        return _res(hb.result()), ha.status

    assert _both(pkgs, run)[1] == "cancelled"
