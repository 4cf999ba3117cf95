"""The fault plane under tensor parallelism, held against the JAX runtime.

``tests/test_faults.py``'s schedules that go through a fork or the
gateway run on ``FaaSRuntime(mesh=ServingMesh(1, 2))`` (two gloo ranks,
the divergence guard on) and on the JAX package's ``FaaSRuntime`` under
the same ``FaultPlan``, over the same weights (smoke smollm, 2 layers,
fp32, converted per rank by ``convert.params_from_jax(..., plan=)``):
statuses, kinds, retry counts, tokens, gateway stats and ``plan.fired``
(point, spec, visit) are equal.  The schedules:

  * an engine crash mid-decode replayed bit for bit, and one with no
    retry budget left failing typed (``engine_step``);
  * a crash between prefill chunks over a borrowed template prefix, and
    one during admission (``prefill_chunk``);
  * a ``weight_fetch`` fault in a fork's streamer: transient (retried
    inside the streamer, tokens equal to the fault-free run) and
    permanent (past the retry budget: the fork fails typed on every
    rank, the workers serve on, and the next invocation is served).

Installing a plan is a mirrored op, so each rank holds a copy: a fetch
fault fires at the same visit on every rank of the instance (read from
every rank's copy).  The points the controller visits before an op is
broadcast fire there only.  ``ServingMesh(2, 2)`` (four ranks) checks the
per-instance copies: a fork on each instance fails at its own instance's
visit 0, and each instance's log equals the JAX runtime's log of that
function's fork alone (the reference counts all instances' visits in one
counter; ROADMAP Queue 3 lists the difference).

The rank functions import no JAX (each rank process imports this
module).
"""

import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tidal  # noqa: E402
from repro_torch.distributed import spawn  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402

MAX_LEN, PS = 32, 4
SCHEDULES = ("crash", "budget", "chunk", "admit", "fetch_transient",
             "fetch_permanent")


def _cfg():
    return reduced(get_config("smollm-135m"), n_layers=2)


def _prompts(seed: int, lens=(8, 7)) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _res(r) -> tuple:
    return (r.status, r.kind, r.retries, [int(t) for t in r.tokens])


def _failures(rt) -> list:
    return [{k: v for k, v in e.items() if k != "error"}
            for e in rt.gateway.failures]


def _fired(plan) -> list:
    return [(f["point"], f["spec"], f["visit"], f.get("instance", 0))
            for f in plan.fired]


def _rt(P, fns=("fn-a", "fn-b"), template=None, **kw):
    kw.setdefault("n_slots", 2)
    rt = P.runtime(max_len=kw.pop("max_len", MAX_LEN), trace_seq=8,
                   page_size=PS, prewarm=False, **kw)
    for i, name in enumerate(fns):
        rt.deploy(P.function(name, i), {},
                  template_prompt=template if i == 0 else None)
    return rt


# ---------------------------------------------------------------------------
# the schedules: each runs on either package (``P``) and returns what must
# agree; ``P.ranks_fired()`` reads every rank's copy of the plan (the port)
# ---------------------------------------------------------------------------

def _crash(P):
    pa, pb = _prompts(0)
    rt = _rt(P)
    rt.submit("fn-a", {}, pa, 2)
    rt.submit("fn-b", {}, pb, 2)
    baseline = list(rt.kv_pool_stats().values())
    plan = P.faults.FaultPlan([P.faults.FaultSpec("engine_step", at=2,
                                                  match="fn-a@")])
    with P.faults.use_fault_plan(plan):
        ha = rt.submit(P.Request("fn-a", pa, max_new_tokens=6))
        hb = rt.submit(P.Request("fn-b", pb, max_new_tokens=6))
        ra, rb = ha.result(), hb.result()
        ranks = P.ranks_fired()
    return {"out": (_res(ra), _res(rb), dict(rt.gateway.stats),
                    _failures(rt), _fired(plan),
                    list(rt.kv_pool_stats().values()) == baseline),
            "ranks": ranks}


def _budget(P):
    pa, pb = _prompts(1, (8, 6))
    rt = _rt(P)
    rt.submit("fn-a", {}, pa, 2)
    rt.submit("fn-b", {}, pb, 2)
    plan = P.faults.FaultPlan([P.faults.FaultSpec("engine_step", at=1,
                                                  match="fn-a@")])
    with P.faults.use_fault_plan(plan):
        ha = rt.submit(P.Request("fn-a", pa, max_new_tokens=6, max_retries=0))
        hb = rt.submit(P.Request("fn-b", pb, max_new_tokens=5))
        try:
            ha.result()
            failed = None
        except P.errors.EngineFailure as e:
            failed = (type(e).__name__, type(e.__cause__).__name__)
        rb = hb.result()
        ranks = P.ranks_fired()
    return {"out": (ha.status, failed, _res(rb), dict(rt.gateway.stats),
                    _fired(plan)),
            "ranks": ranks}


def _chunk(P):
    rng = np.random.default_rng(2)
    template = rng.integers(0, 256, 12).astype(np.int32)
    borrower = np.concatenate([template, rng.integers(0, 256, 16)
                               ]).astype(np.int32)
    other = rng.integers(0, 256, 6).astype(np.int32)
    rt = _rt(P, template=template, max_len=48, chunk_tokens=8)
    baseline = list(rt.kv_pool_stats().values())
    plan = P.faults.FaultPlan([P.faults.FaultSpec("prefill_chunk", at=1,
                                                  match="chunk:")])
    with P.faults.use_fault_plan(plan):
        ha = rt.submit(P.Request("fn-a", borrower, max_new_tokens=6))
        hb = rt.submit(P.Request("fn-b", other, max_new_tokens=6))
        ra, rb = ha.result(), hb.result()
        ranks = P.ranks_fired()
    return {"out": (_res(ra), _res(rb), _failures(rt), ra.reused_prefix_len,
                    [f["detail"] for f in plan.fired], _fired(plan),
                    list(rt.kv_pool_stats().values()) == baseline),
            "ranks": ranks}


def _admit(P):
    (p,) = _prompts(3, (8,))
    rt = _rt(P, fns=("fn",))
    rt.submit("fn", {}, p, 2)
    plan = P.faults.FaultPlan([P.faults.FaultSpec("prefill_chunk", at=0,
                                                  match="admit:")])
    with P.faults.use_fault_plan(plan):
        res = rt.submit(P.Request("fn", p, max_new_tokens=5)).result()
        ranks = P.ranks_fired()
    return {"out": (_res(res), _failures(rt), _fired(plan),
                    list(rt.kv_pool_stats().values())),
            "ranks": ranks}


def _fetch(P, times: int):
    """A fork whose first streamed weight fails ``times`` times (the
    streamer retries twice): served after retries, or failing typed with
    no request retry left, after which the next invocation is served."""
    (p,) = _prompts(4, (9,))
    rt = _rt(P, fns=("fn",))
    want = _res(rt.submit(P.Request("fn", p, max_new_tokens=5)).result())
    rt.evict("fn")
    plan = P.faults.FaultPlan([P.faults.FaultSpec("weight_fetch", at=0,
                                                  times=times)])
    with P.faults.use_fault_plan(plan):
        h = rt.submit(P.Request("fn", p, max_new_tokens=5, max_retries=0))
        try:
            got = _res(h.result())
        except P.errors.EngineFailure as e:
            got = (h.status, type(e).__name__, type(e.__cause__).__name__)
        ranks = P.ranks_fired()
    after = _res(rt.submit(P.Request("fn", p, max_new_tokens=5)).result())
    return {"out": (want, got, after, _fired(plan),
                    rt.gateway.stats["engine_failures"]),
            "ranks": ranks}


def _fetch_transient(P):
    return _fetch(P, 1)


def _fetch_permanent(P):
    return _fetch(P, 3)


def _instances_fetch(P):
    """Two functions on two instances, each forked once under a transient
    fetch fault at visit 0 (of each instance's copy on the port)."""
    pa, pb = _prompts(5, (8, 7))
    rt = _rt(P)
    want = [_res(rt.submit(P.Request(n, p, max_new_tokens=5)).result())
            for n, p in (("fn-a", pa), ("fn-b", pb))]
    placed = P.placed(rt)
    rt.evict()
    plan = P.faults.FaultPlan([P.faults.FaultSpec("weight_fetch", at=0)])
    with P.faults.use_fault_plan(plan):
        got = [_res(rt.submit(P.Request(n, p, max_new_tokens=5)).result())
               for n, p in (("fn-a", pa), ("fn-b", pb))]
        ranks = P.ranks_fired()
    return {"want": want, "got": got, "placed": placed, "after": P.placed(rt),
            "fired": _fired(plan), "ranks": ranks}


# ---------------------------------------------------------------------------
# what every rank runs (no JAX here)
# ---------------------------------------------------------------------------

def _rank_fired() -> list:
    """This rank's own log (the controller's without its merge of the
    other instances' copies)."""
    from repro_torch.runtime.faults import active_fault_plan
    return [(f["point"], f["visit"]) for f in active_fault_plan().fired
            if "instance" not in f]


def _placed(rt) -> dict:
    return {k[0]: w.instance for k, w in rt._engines.items()}


# the functions every schedule deploys: (name, weight set)
FUNCTIONS = (("fn-a", 0), ("fn-b", 1), ("fn", 0))


def _torch_pkg(group, model, fns):
    import repro_torch.runtime.errors as errors
    import repro_torch.runtime.faults as faults
    from repro_torch.runtime import FaaSRuntime
    from repro_torch.runtime.gateway import InvocationRequest
    return types.SimpleNamespace(
        errors=errors, faults=faults, function=lambda n, i: fns[(n, i)],
        Request=InvocationRequest,
        runtime=lambda **kw: FaaSRuntime(mesh=group.mesh, device="cpu", **kw),
        ranks_fired=lambda: group.gather(_rank_fired),
        placed=_placed)


def _ranks(group, jax_params: list, schedules: tuple) -> dict:
    cfg = _cfg()
    model = get_model(cfg, device="cpu", plan=group.plan)
    params = [group.bind(convert.params_from_jax(p, cfg, device="cpu",
                                                 plan=group.plan))
              for p in jax_params]
    fns = {(n, i): group.bind(tidal.static_function(n, model, params[i]))
           for n, i in FUNCTIONS}
    if not group.is_controller:
        group.serve()
        return None
    P = _torch_pkg(group, model, fns)
    return {name: globals()["_" + name](P) for name in schedules}


# ---------------------------------------------------------------------------
# the tests (JAX on this side only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pkg():
    import jax
    import repro.core.api as jax_api
    import repro.runtime.errors as jax_errors
    import repro.runtime.faas as jax_faas
    import repro.runtime.faults as jax_faults
    import repro.runtime.gateway as jax_gateway
    from repro.models.registry import get_smoke_model as jax_smoke
    jm = jax_smoke("smollm-135m", n_layers=2)
    jps = [jm.init_params(jax.random.PRNGKey(s)) for s in (0, 1)]
    return types.SimpleNamespace(
        errors=jax_errors, faults=jax_faults,
        function=lambda n, i: jax_api.static_function(n, jm, jps[i]),
        Request=jax_gateway.InvocationRequest,
        runtime=lambda **kw: jax_faas.FaaSRuntime(**kw),
        ranks_fired=lambda: None,
        placed=lambda rt: None,
        numpy=[jax.tree.map(np.asarray, p) for p in jps])


@pytest.fixture(scope="module")
def tp(jax_pkg):
    return spawn(_ranks, 2, (jax_pkg.numpy, SCHEDULES), device="cpu",
                 guard=True, timeout_s=600, collective_timeout_s=120)


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_at_tp2_matches_jax_runtime(tp, jax_pkg, name):
    """Statuses, kinds, retries, tokens, typed failures, gateway stats
    and ``plan.fired`` equal the JAX runtime's under the same plan."""
    want = globals()["_" + name](jax_pkg)
    assert tp[name]["out"] == want["out"]


@pytest.mark.parametrize("name", SCHEDULES)
def test_fault_fires_where_its_point_is_visited(tp, name):
    """Each rank holds a copy of the plan: a fetch fault fires at the same
    visit on both ranks; the controller-only points fire on rank 0 only."""
    ranks = tp[name]["ranks"]
    assert len(ranks) == 2
    if name.startswith("fetch"):
        assert ranks[0] == ranks[1] and ranks[0]
        assert {p for p, _ in ranks[0]} == {"weight_fetch"}
    else:
        assert ranks[0] and ranks[1] == []


def test_fetch_faults_are_transient_then_permanent(tp):
    want, got, after, fired, failures = tp["fetch_transient"]["out"]
    assert got[1] == "fork" and got[2] == 0 and failures == 0
    assert got[3] == want[3] == after[3]
    assert fired == [("weight_fetch", 0, 0, 0)]
    want, got, after, fired, failures = tp["fetch_permanent"]["out"]
    assert got == ("failed", "EngineFailure", "WeightFetchFault")
    assert after[0] == "done" and after[3] == want[3] and failures == 1
    assert [v for _, _, v, _ in fired] == [0, 1, 2]


def test_instance_copies_fire_per_instance(jax_pkg):
    """``ServingMesh(2, 2)``: each instance's fork fails at its own visit
    0 and is retried to the fault-free tokens; each instance's log (the
    controller's merge) equals the JAX runtime's for that fork alone."""
    out = spawn(_ranks, 2, (jax_pkg.numpy, ("instances_fetch",)), data=2,
                device="cpu", guard=True, timeout_s=600,
                collective_timeout_s=120)["instances_fetch"]
    assert [g[3] for g in out["got"]] == [w[3] for w in out["want"]]
    assert [g[:3] for g in out["got"]] == [("done", "fork", 0)] * 2
    assert sorted(out["placed"].values()) == [0, 1]
    assert out["after"] == out["placed"]
    inst = {out["placed"]["fn-a"]: "fn-a", out["placed"]["fn-b"]: "fn-b"}
    by_instance = {i: [f[:3] for f in out["fired"] if f[3] == i]
                   for i in (0, 1)}
    prompts = dict(zip(("fn-a", "fn-b"), _prompts(5, (8, 7))))
    for i, name in inst.items():
        P = jax_pkg
        rt = _rt(P)
        p = prompts[name]
        rt.submit(P.Request(name, p, max_new_tokens=5)).result()
        rt.evict()
        plan = P.faults.FaultPlan([P.faults.FaultSpec("weight_fetch", at=0)])
        with P.faults.use_fault_plan(plan):
            rt.submit(P.Request(name, p, max_new_tokens=5)).result()
        assert by_instance[i] == [f[:3] for f in _fired(plan)]
    # every rank of an instance saw its instance's fault
    ranks = out["ranks"]
    assert len(ranks) == 4
    assert ranks[0] == ranks[1] == [("weight_fetch", 0)]
    assert ranks[2] == ranks[3] == [("weight_fetch", 0)]
