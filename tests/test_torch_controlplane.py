"""The port's control plane, held against the JAX one on the CPU.

The same inputs go through both packages (smoke smollm at 2 layers,
fp32, the same weights carried by ``convert.params_from_jax``): arrival
forecasts, the prefix observer's nominations, runtime-learned prefix
bakes with their reuse hits and greedy tokens, pinned-budget churn,
deferred reclaim under a live borrower, prewarm forks, predictive
keep-alive, ``trace_schedule`` over each package's scheduler trace (the
two traces equal) and ``measure_service_times``' service kinds must be
equal.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.api as jax_api  # noqa: E402
import repro.runtime.controlplane as jax_cp  # noqa: E402
import repro.runtime.faas as jax_faas  # noqa: E402
import repro.runtime.gateway as jax_gateway  # noqa: E402
import repro_torch.core.api as torch_api  # noqa: E402
import repro_torch.core.scheduler as torch_sched  # noqa: E402
import repro_torch.runtime.controlplane as torch_cp  # noqa: E402
import repro_torch.runtime.faas as torch_faas  # noqa: E402
import repro_torch.runtime.gateway as torch_gateway  # noqa: E402
import repro.core.scheduler as jax_sched  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402

MAX_LEN = 48
PS = 8
PREFIX_LEN = 2 * PS                       # a 2-page shared prompt root


@pytest.fixture(scope="module")
def pkgs():
    jm = jax_smoke("smollm-135m", n_layers=2)
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=2)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return [types.SimpleNamespace(
                api=jax_api, cp=jax_cp, faas=jax_faas, sched=jax_sched,
                model=jm, params=jp,
                Request=jax_gateway.InvocationRequest,
                runtime=jax_faas.FaaSRuntime,
                pool=lambda rt: rt._pool_for(rt.instances[0], jm)),
            types.SimpleNamespace(
                api=torch_api, cp=torch_cp, faas=torch_faas,
                sched=torch_sched, model=tm,
                params=tp, Request=torch_gateway.InvocationRequest,
                runtime=lambda **kw: torch_faas.FaaSRuntime(device="cpu", **kw),
                pool=lambda rt: rt._pool_for(tm))]


def _both(pkgs, scenario):
    """Run ``scenario(P)`` on each package; the outcomes must match."""
    outs = [scenario(P) for P in pkgs]
    assert outs[0] == outs[1]
    return outs[1]


def _runtime(P, template_prompt=None, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("page_size", PS)
    kw.setdefault("trace_seq", PREFIX_LEN)
    kw.setdefault("prewarm", False)
    rt = P.runtime(**kw)
    rt.deploy(P.api.static_function("fn", P.model, P.params), {},
              template_prompt=template_prompt)
    return rt


def _shared_prefix_prompts(n, seed=0, suffix_len=PS):
    """``n`` prompts sharing one 2-page prefix with distinct suffixes."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, PREFIX_LEN)
    return prefix.astype(np.int32), [
        np.concatenate([prefix, rng.integers(0, 256, suffix_len)]
                       ).astype(np.int32) for _ in range(n)]


def test_predictor_and_observer_match_jax(pkgs):
    def scenario(P):
        p = P.cp.EwmaHistogramPredictor()
        for t in (0.0, 10.0, 21.0, 30.0, 40.5, 52.0):
            p.observe("f", t)
        fc = [(p.rate("f", now), p.p_within("f", now, h), p.next_eta("f", now))
              for now in (52.5, 58.0, 61.0, 300.0) for h in (1.0, 2.5, 9.0)]
        fc.append((p.rate("ghost", 1.0), p.p_within("ghost", 1.0, 5.0),
                   p.next_eta("ghost", 1.0), p.functions()))
        obs = P.cp.PrefixObserver(PS, min_hits=3, max_nodes=16)
        prefix, prompts = _shared_prefix_prompts(4)
        for i, prompt in enumerate(prompts):
            obs.observe(("fn", ()), prompt, now=float(i))
        rng = np.random.default_rng(7)
        for i in range(12):                  # cold prompts churn the table
            obs.observe(("fn", ()), rng.integers(0, 256, 3 * PS).astype(
                np.int32), now=10.0 + i)
        noms = [(k, n.tokens.tolist(), n.count) for k, n in
                obs.nominate(now=30.0, limit=8)]
        return fc, noms, len(obs)

    fc, noms, n = _both(pkgs, scenario)
    assert [k[1] for k, _, _ in noms] == [2] and n <= 16


def test_learned_prefix_reuse_matches_jax(pkgs):
    """An undeclared shared root is observed, baked at runtime and reused
    suffix-only by the next invocation, with the same tokens."""
    _, prompts = _shared_prefix_prompts(4)

    def scenario(P):
        rt = _runtime(P)
        cp = P.cp.ControlPlane(rt, min_hits=3, tick_interval_s=0.0)
        rows = [(r.kind, r.reused_prefix_len, r.tokens.tolist())
                for r in (rt.submit("fn", {}, p, 4) for p in prompts[:3])]
        cp.tick()
        hit = rt.submit("fn", {}, prompts[3], 4)
        rows.append((hit.kind, hit.reused_prefix_len, hit.tokens.tolist()))
        return (rows, dict(cp.stats), cp.pinned_nbytes(),
                [len(h.pages) for h in cp.learned_prefixes()],
                rt.stats()["functions"]["fn"], rt.stats()["control_plane"])

    rows, stats, pinned, pages, fn, cps = _both(pkgs, scenario)
    assert rows[3][1] == PREFIX_LEN and stats["prefix_bakes"] == 1
    assert [r[1] for r in rows[:3]] == [0, 0, 0] and pages == [2]
    assert 0 < pinned and fn["reuse_hits"] == 1 and cps == stats


def test_bake_validations_and_deferred_reclaim_match_jax(pkgs):
    """Evicting a borrowed learned prefix unregisters it at once and frees
    its pages only when the last borrower releases."""
    _, prompts = _shared_prefix_prompts(1)

    def scenario(P):
        rt = _runtime(P, template_prompt=np.arange(PREFIX_LEN, dtype=np.int32))
        errs = []
        for bad in (np.arange(PS + 1), np.arange(MAX_LEN)):
            with pytest.raises(ValueError) as e:
                rt.bake_runtime_prefix("fn", bad.astype(np.int32))
            errs.append(str(e.value))
        with pytest.raises(KeyError):
            rt.bake_runtime_prefix("ghost", prompts[0])
        covered = rt.bake_runtime_prefix("fn", np.arange(PREFIX_LEN,
                                                         dtype=np.int32))
        pool = P.pool(rt)
        base_free = pool.n_free_pages
        handle = rt.bake_runtime_prefix("fn", prompts[0][:PREFIX_LEN])
        refs = [pool.prefix_page_refs(handle), pool.n_free_pages - base_free]
        h = rt.gateway.submit(P.Request("fn", prompts[0], max_new_tokens=4))
        stream = h.tokens()
        next(stream)
        refs.append(pool.prefix_page_refs(handle))
        rt.release_runtime_prefix(handle)
        refs += [handle.pinned, pool.prefix_page_refs(handle)]
        h2 = rt.gateway.submit(P.Request("fn", prompts[0], max_new_tokens=4))
        r1, r2 = h.result(), h2.result()
        rt.evict()
        refs += [pool.prefix_page_refs(handle), pool.n_free_pages - base_free]
        return (errs, covered, refs, r1.reused_prefix_len, r2.reused_prefix_len,
                r1.tokens.tolist(), r2.tokens.tolist())

    _, covered, refs, reuse1, reuse2, t1, t2 = _both(pkgs, scenario)
    assert covered is None
    assert refs == [[1, 1], -2, [2, 2], False, [1, 1], [0, 0], 0]
    assert reuse1 == PREFIX_LEN and reuse2 == 0 and t1 == t2


def test_pinned_budget_churn_matches_jax(pkgs):
    """With a budget of one 2-page bake, alternating hot roots evict each
    other; pinned bytes never overshoot and every page comes back."""
    roots = [_shared_prefix_prompts(3, seed=s)[1] for s in (1, 2)]

    def scenario(P):
        rt = _runtime(P)
        pool = P.pool(rt)
        base_free = pool.n_free_pages
        budget = rt.runtime_prefix_nbytes("fn", PREFIX_LEN)
        cp = P.cp.ControlPlane(rt, pinned_bytes_budget=budget, min_hits=3,
                               tick_interval_s=0.0)
        now, trail = 0.0, []
        for rnd in range(4):
            for prompt in roots[rnd % 2]:
                now += 0.01
                cp.on_completion("fn", {}, prompt, "warm", 0, now)
            cp.tick(now)
            trail.append((cp.pinned_nbytes(), len(cp.learned_prefixes()),
                          [h.tokens.tolist() for h in cp.learned_prefixes()]))
        never = P.cp.ControlPlane(_runtime(P), pinned_bytes_budget=1,
                                  min_hits=3, tick_interval_s=0.0)
        for i, p in enumerate(roots[0]):
            never.on_completion("fn", {}, p, "warm", 0, float(i))
        never.tick(1.0)
        dropped = rt._drop_runtime_prefixes()
        rt.evict()
        return (budget, trail, dict(cp.stats), dropped, cp.pinned_nbytes(),
                pool.n_free_pages - base_free, dict(never.stats),
                never.observer.nominate(2.0))

    budget, trail, stats, dropped, pinned, freed, never, noms = _both(
        pkgs, scenario)
    assert all(0 < b <= budget and n == 1 for b, n, _ in trail)
    assert stats["prefix_bakes"] == 4 and stats["prefix_evictions"] == 3
    assert dropped == 1 and pinned == 0 and freed == 0
    assert never["prefix_bakes"] == 0 and noms == []


def test_prewarm_and_predictive_keep_alive_match_jax(pkgs):
    def scenario(P):
        rt = _runtime(P, keep_alive_s=1e9)
        cp = P.cp.ControlPlane(rt, prewarm_horizon_s=5.0, prewarm_p=0.5,
                               tick_interval_s=0.0)
        for t in (100.0, 110.0, 120.0, 130.0):
            cp.on_arrival("fn", t, {})
        rt.evict()
        seen = []
        for now in (131.0, 138.0, 138.5):
            cp.tick(now=now)
            seen.append((cp.stats["prewarm_forks"], rt.warm_engines()))
        ka = P.cp.ControlPlane(extend_factor=6.0, extend_p=0.5,
                               release_factor=0.25, release_p=0.05,
                               min_observations=4)
        for t in (0.0, 10.0, 20.0, 30.0, 40.0):
            ka.predictor.observe("hot", t)
        ka.predictor.observe("cold-guess", 0.0)
        windows = [ka.keep_alive_s_for("hot", 2.0, now=41.0),
                   ka.keep_alive_s_for("hot", 2.0, now=300.0),
                   ka.keep_alive_s_for("cold-guess", 2.0, now=300.0)]
        # _prune expires under the predictive window once one is attached
        cp.keep_alive_s_for = lambda fn, default_s, now=None: 0.0
        rt._prune(rt._engines[rt.warm_engines()[0]].last_used_s + 1.0)
        return seen, windows, rt.warm_engines()

    seen, windows, left = _both(pkgs, scenario)
    assert [s[0] for s in seen] == [0, 1, 1] and not seen[0][1]
    assert windows == [12.0, 0.5, 2.0] and left == []


def test_trace_schedule_of_a_scheduler_trace_matches_jax(pkgs):
    """Each package's scheduler trace (equal for the same seed) becomes
    the same gateway schedule in both packages."""
    traces = {}
    for P in pkgs:
        trace = P.sched.make_trace({"mail-fn": 2.0, "code-fn": 1.0}, 5.0,
                                   {"mail-fn": "mail", "code-fn": "code"},
                                   seed=3, fn_deadlines={"mail-fn": 0.25},
                                   fn_priorities={"code-fn": 2})
        trace.append(P.sched.SimRequest("fn", 5.5, 16, len(trace),
                                        deadline_s=0.2, priority=3))
        traces[id(P)] = trace
    jax_trace, port_trace = (traces[id(P)] for P in pkgs)
    assert ([dataclasses.astuple(r) for r in port_trace]
            == [dataclasses.astuple(r) for r in jax_trace])

    def scenario(P):
        trace = traces[id(P)]
        sched = P.cp.trace_schedule(
            trace, lambda r: np.arange(r.input_len % 40 + 1, dtype=np.int32),
            max_new_tokens=2, event_for=lambda r: {"k": r.req_id})
        return [(due, r.fn_name, np.asarray(r.prompt).tolist(), r.event,
                 r.max_new_tokens, r.deadline_s, r.priority)
                for due, r in sched]

    rows = _both(pkgs, scenario)
    assert len(rows) == len(port_trace) and rows[-1][5:] == (0.2, 3)


def test_measure_service_times_kinds_match_jax(pkgs):
    def scenario(P):
        rt = P.runtime(n_slots=2, max_len=32, trace_seq=16, prewarm=False)
        rt.deploy(P.api.static_function("fn-s", P.model, P.params), {})
        m = P.faas.measure_service_times(rt, {"fn-s": {}}, prompt_len=8,
                                         max_new_tokens=2, warm_reps=1,
                                         prompt_lens=[8, 16])
        kinds = {fn: {k: [length for length, _ in v] for k, v in d.items()}
                 for fn, d in m.times.items()}
        oracle = P.faas.MeasuredServiceTimes(
            {"*": {"warm": [(8, 0.01), (16, 0.03)], "cold": 0.5}},
            measured_prompt_len=8)
        return (kinds, m.measured_prompt_len,
                oracle.service_s("x", "warm", 12), oracle.service_s("x", "cold"),
                oracle.service_s("x", "fork"), oracle.summary())

    kinds = _both(pkgs, scenario)[0]
    assert kinds == {"fn-s": {"cold": [8], "fork": [8, 16], "warm": [8, 16]}}
