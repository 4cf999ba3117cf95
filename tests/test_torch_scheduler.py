"""The port's cluster scheduler, held against the JAX package on the CPU.

``make_trace`` draws the same requests for the same seed, a JSONL trace
written by either package reads back equal in the other, and
``ClusterSim`` gives equal per-request results and equal ``summarize``
under every policy, with straggler hedging, elastic capacity, seeded
crashes with retries and in measured mode (a stub table that falls back
to the analytic oracle).  Each package runs on its own plans (the port's
traced on ``meta``) and its own copy of the paper's A6000 profile.  Then
``tests/test_scheduler.py``'s claims run on the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.plans as jax_plans  # noqa: E402
import repro.core.scheduler as jax_sched  # noqa: E402
import repro.runtime.faas as jax_faas  # noqa: E402
import repro_torch.core.plans as torch_plans  # noqa: E402
import repro_torch.core.scheduler as sched  # noqa: E402
import repro_torch.runtime.faas as torch_faas  # noqa: E402
from repro_torch.core.scheduler import (ClusterSim,  # noqa: E402
                                        SchedulerConfig, SimRequest,
                                        make_trace, summarize)

RATES = {"static": 0.3, "dyn": 0.2, "tpl": 0.25}
TASKS = {"static": "conv", "dyn": "mail", "tpl": "code"}


def _profiles(S, plans):
    plan = plans.plan_for("llama3-8b", 1, 1024)
    total = plan.total_weight_bytes

    def mk(name, dyn, tpl):
        return S.FunctionProfile(
            name=name, plan_for_len=lambda L: plans.plan_for("llama3-8b", 1, L),
            dynamic_bytes=int(total * 0.01) if dyn else 0,
            template_bytes=tpl, model_bytes=total)
    return {"static": mk("static", False, 0), "dyn": mk("dyn", True, 0),
            "tpl": mk("tpl", False, total // 3)}


@pytest.fixture(scope="module")
def both():
    return [(jax_sched, _profiles(jax_sched, jax_plans), jax_faas),
            (sched, _profiles(sched, torch_plans), torch_faas)]


def _trace(S, seed=3, duration=200.0, load=1.0):
    """A seeded trace; ``load`` scales every rate (and shortens the
    window, keeping the request count)."""
    return S.make_trace({fn: r * load for fn, r in RATES.items()},
                        duration / load, TASKS, seed=seed,
                        fn_deadlines={"dyn": 20.0 / load},
                        fn_priorities={"tpl": 1})


def _rows(results):
    return [(dataclasses.astuple(r.req), r.ttft_s, r.service_s, r.queue_s,
             r.kind, r.rejected, r.hedged, r.shed, r.failed, r.retries)
            for r in results]


def test_make_trace_matches_jax():
    for seed in (0, 3, 11):
        got = [dataclasses.astuple(r) for r in _trace(sched, seed)]
        want = [dataclasses.astuple(r) for r in _trace(jax_sched, seed)]
        assert got == want and len(got) > 50


def test_traces_round_trip_across_packages(tmp_path):
    trace = _trace(sched)
    trace.append(SimRequest("fn", 201.5, 16, len(trace), deadline_s=0.2,
                            priority=3))
    port_file, jax_file = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert sched.export_trace(trace, str(port_file)) == len(trace)
    back = jax_sched.import_trace(str(port_file))
    assert [dataclasses.astuple(r) for r in back] == [
        dataclasses.astuple(r) for r in trace]
    jax_sched.export_trace(back, str(jax_file))
    assert jax_file.read_text() == port_file.read_text()
    again = sched.import_trace(str(jax_file))
    assert again == trace


def _stub(faas):
    """A measured table covering some functions and kinds: every other
    lookup falls back to the analytic oracle."""
    return faas.MeasuredServiceTimes(
        {"static": {"warm": [(867, 0.02), (2048, 0.05)], "cold": 1.5},
         "tpl": {"warm": 0.03}}, measured_prompt_len=1154)


# (config, load): the loaded traces queue, so that hedging, elastic
# capacity, early rejects and deadline sheds all happen
CONFIGS = {
    "serverlessllm": (dict(policy="serverlessllm"), 1.0),
    "tidal": (dict(policy="tidal"), 1.0),
    "tidal-dk": (dict(policy="tidal-dk", dk=True), 1.0),
    "hedged-elastic": (dict(policy="tidal-dk", dk=True, hedge_after=0.5,
                            capacity_events=((4.0, 2), (12.0, -1))), 20.0),
    "crashes": (dict(policy="tidal", crash_rate=0.2, crash_seed=5), 1.0),
    "measured": (dict(policy="tidal-dk", dk=True, measured="stub"), 1.0),
    "tight": (dict(policy="serverlessllm", timeout_s=3.0, hbm_budget=20e9),
              20.0),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cluster_sim_matches_jax(both, name):
    outs = []
    kw, load = CONFIGS[name]
    for S, profiles, faas in both:
        kw = dict(kw)
        if kw.get("measured") == "stub":
            kw["measured"] = _stub(faas)
        cfg = S.SchedulerConfig(n_gpus=2, keep_alive_s=5.0, **kw)
        res = S.ClusterSim(cfg, profiles).run(_trace(S, load=load))
        outs.append((_rows(res), S.summarize(res)))
    (jax_rows, jax_sum), (port_rows, port_sum) = outs
    assert len(port_rows) == len(jax_rows) > 50
    for got, want in zip(port_rows, jax_rows):
        assert got[0] == want[0] and got[4:] == want[4:]
        np.testing.assert_allclose(got[1:4], want[1:4], rtol=1e-12, atol=0)
    assert port_sum.keys() == jax_sum.keys()
    for k in port_sum:
        if isinstance(port_sum[k], float):
            assert port_sum[k] == pytest.approx(jax_sum[k], rel=1e-12)
        else:
            assert port_sum[k] == jax_sum[k], k


def test_measured_lookups_come_from_the_table(both):
    """In measured mode every (function, kind) the table holds is served
    from it; the rest fall back to the analytic oracle."""
    _, profiles, _ = both[1]
    table = _stub(torch_faas)
    calls = []

    class Counting:
        def service_s(self, fn, kind, input_len):
            t = table.service_s(fn, kind, input_len)
            calls.append((fn, kind, t is not None))
            return t

    res = ClusterSim(SchedulerConfig(n_gpus=2, keep_alive_s=5.0,
                                     measured=Counting()),
                     profiles).run(_trace(sched))
    served = [r for r in res if not (r.rejected or r.shed)]
    assert len(calls) == len(served)
    hits = [(fn, kind) for fn, kind, hit in calls if hit]
    assert hits and {("static", "warm"), ("tpl", "warm")} <= set(hits)
    assert all(kind in table.times.get(fn, {}) for fn, kind in hits)
    for r in served:
        if r.req.fn_name == "tpl" and r.kind == "warm":
            assert r.service_s == 0.03


# ---------------------------------------------------------------------------
# tests/test_scheduler.py's claims, on the port
# ---------------------------------------------------------------------------

def _reqs(fn, times, ilen=1024):
    return [SimRequest(fn, t, ilen, i) for i, t in enumerate(times)]


def _keep_alive_warm_hits(profiles):
    cfg = SchedulerConfig(n_gpus=1, policy="tidal", keep_alive_s=10.0)
    res = ClusterSim(cfg, profiles).run(_reqs("static", [0.0, 5.0, 30.0]))
    assert [r.kind for r in res] == ["cold", "warm", "cold"]
    assert res[1].ttft_s < res[0].ttft_s


def _dynamic_needs_dk_for_keepalive(profiles):
    reqs = _reqs("dyn", [0.0, 2.0])
    cold = ClusterSim(SchedulerConfig(n_gpus=1, policy="tidal", dk=False,
                                      keep_alive_s=10.0), profiles).run(reqs)
    dk = ClusterSim(SchedulerConfig(n_gpus=1, policy="tidal", dk=True,
                                    keep_alive_s=10.0), profiles).run(reqs)
    assert cold[1].kind == "cold" and dk[1].kind == "fork"
    assert dk[1].ttft_s < cold[1].ttft_s


def _early_reject(profiles):
    cfg = SchedulerConfig(n_gpus=1, policy="tidal", timeout_s=3.0)
    res = ClusterSim(cfg, profiles).run(_reqs("static", [0.0] * 30))
    rejected = [r for r in res if r.rejected]
    assert rejected and all(r.ttft_s == cfg.timeout_s for r in rejected)


def _locality_prefers_warm_gpu(profiles):
    cfg = SchedulerConfig(n_gpus=4, policy="tidal", keep_alive_s=60.0)
    res = ClusterSim(cfg, profiles).run(_reqs("static", [0.0, 10.0, 20.0]))
    assert [r.kind for r in res[1:]] == ["warm", "warm"]


def _tidal_beats_serverlessllm_p95(profiles):
    trace = make_trace({"static": 0.08, "dyn": 0.08}, 400.0,
                       {"static": "conv", "dyn": "mail"}, seed=3)
    base = ClusterSim(SchedulerConfig(n_gpus=2, policy="serverlessllm",
                                      keep_alive_s=2.0), profiles).run(trace)
    tid = ClusterSim(SchedulerConfig(n_gpus=2, policy="tidal", dk=True,
                                     keep_alive_s=2.0), profiles).run(trace)
    sb, stt = summarize(base), summarize(tid)
    assert stt["p95"] < sb["p95"] and stt["p50"] < sb["p50"]


def _elastic_scale_up_reduces_queueing(profiles):
    reqs = _reqs("static", list(np.linspace(0, 2, 40)))
    small = ClusterSim(SchedulerConfig(n_gpus=1, policy="tidal"),
                       profiles).run(reqs)
    elastic = ClusterSim(SchedulerConfig(
        n_gpus=1, policy="tidal", capacity_events=((2.0, +3),)),
        profiles).run(reqs)
    assert sum(r.queue_s for r in elastic) < sum(r.queue_s for r in small)


def _straggler_hedging(profiles):
    cfg = SchedulerConfig(n_gpus=3, policy="tidal", hedge_after=0.5)
    res = ClusterSim(cfg, profiles).run(_reqs("static", [0.0] * 6))
    assert any(r.hedged for r in res) and not any(r.rejected for r in res)


def _hbm_eviction(profiles):
    total = profiles["static"].model_bytes
    cfg = SchedulerConfig(n_gpus=1, policy="tidal", hbm_budget=total * 1.5,
                          keep_alive_s=100.0)
    reqs = [SimRequest("static", 0.0, 512, 0), SimRequest("dyn", 5.0, 512, 1),
            SimRequest("static", 10.0, 512, 2)]
    assert len(ClusterSim(cfg, profiles).run(reqs)) == 3


def _trace_generation_rates(profiles):
    trace = make_trace({"a": 1.0, "b": 0.1}, 1000.0,
                       {"a": "mail", "b": "code"}, seed=0)
    na = sum(r.fn_name == "a" for r in trace)
    nb = sum(r.fn_name == "b" for r in trace)
    assert 800 < na < 1200 and 60 < nb < 140
    assert all(t0.arrival_s <= t1.arrival_s for t0, t1 in zip(trace, trace[1:]))


CLAIMS = [_keep_alive_warm_hits, _dynamic_needs_dk_for_keepalive,
          _early_reject, _locality_prefers_warm_gpu,
          _tidal_beats_serverlessllm_p95, _elastic_scale_up_reduces_queueing,
          _straggler_hedging, _hbm_eviction, _trace_generation_rates]


@pytest.mark.parametrize("claim", CLAIMS, ids=lambda f: f.__name__[1:])
def test_scheduler_claims_on_the_port(both, claim):
    claim(both[1][1])

