"""Tensor-parallel serving on the CPU: two gloo ranks against the JAX
package on one device.

One spawn of two ranks per module (``repro_torch.distributed.spawn``,
gloo, the divergence guard on) runs every scenario, for the smoke smollm
at 2 layers with 2 KV heads (split over the ranks), with 1 (each rank
keeps it), and with smollm-135m's own 9 query / 3 KV heads, which the
two ranks do not divide (``sharding.head_split``: 6 / 2 on rank 0, 3 / 1
on rank 1): the weights are the JAX package's, converted per rank by
``convert.params_from_jax(..., plan=)``.  The checks, each its own test:

  * ``FaaSRuntime(mesh=ServingMesh(1, 2))`` serves cold, fork (streamed
    prefill while the weights are in flight), a template-prefix hit and
    warm: greedy tokens equal ``repro.runtime.engine.Engine``'s on one
    device, over the fp and the int8 arena;
  * the first prefill's logits within 1e-5 of the largest |logit| of the
    JAX prefill's (fp32), and the sequential ``Engine`` under the plan
    against the JAX ``Engine``;
  * the forks' byte counts per rank: their sum is the one-device fork's
    plus the replicated leaves once more (equal shards where the heads
    split evenly, rank 0's the larger where they do not);
  * a KV pool's page tables, refcounts and free lists identical on both
    ranks and equal to the JAX pool's after the same operation sequence;
  * deadlines through the gateway's pump thread end without a hang, and
    an op that raises on every rank leaves the group serving;
  * the divergence guard raises on every rank when one rank's pool state
    is forged, instead of hanging;
  * with the guard off, an op that raises on one rank only raises
    ``DivergenceError`` on every rank, and ``spawn`` reports the worker's
    (a spawn of its own per case: the channel is broken after it);
  * under a ``prefer_seq`` plan (the cache split by sequence, each rank
    holding half the positions of every KV head) a prefill and greedy
    decode steps through ``decode_attention_slice`` and
    ``decode_merge_ranks`` give the JAX ``decode_step``'s tokens and fp32
    logits, with two ``all_gather`` per layer per step beside the
    ``all_reduce`` of one device's plan.

The rank functions below import no JAX (each rank process imports this
module).  ``test_torch_tp_specs.py`` holds the specs against JAX's.
"""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tidal  # noqa: E402
from repro_torch.distributed import DivergenceError, spawn  # noqa: E402
from repro_torch.distributed.group import current_group, mirrored  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MAX_LEN, PS, NEW = 32, 8, 5
UNEVEN = "9/3"                     # smollm-135m's heads, split unevenly
KVS = (2, 1, UNEVEN)               # KV heads split, kept on every rank,
                                   # and query heads split unevenly


def _cfg(kv):
    if kv == UNEVEN:
        return reduced(get_config("smollm-135m"), n_layers=2,
                       **_uneven_heads())
    return reduced(get_config("smollm-135m"), n_layers=2, n_kv_heads=kv)


def _uneven_heads() -> dict:
    return {"n_heads": 9, "n_kv_heads": 3}


def _workload():
    rng = np.random.default_rng(5)
    tpl = rng.integers(1, 256, PS).astype(np.int32)
    p0 = rng.integers(1, 256, 9).astype(np.int32)
    p1 = rng.integers(1, 256, 11).astype(np.int32)
    hit = np.concatenate([tpl, rng.integers(1, 256, 6)]).astype(np.int32)
    return tpl, [("cold", p0), ("fork", p1), ("hit", hit), ("warm", p0)]


# ---------------------------------------------------------------------------
# what every rank runs (no JAX here)
# ---------------------------------------------------------------------------

def _pool_state(pool) -> tuple:
    return (pool.page_table.tolist(), pool._page_refs.tolist(),
            sorted(pool._free_pages), pool.n_free_slots,
            pool.n_available_pages, dict(pool.stats))


def _worker_failures() -> int:
    return len(current_group().channel.failures)


@mirrored()
def _forge_free_list(pool, rank: int) -> None:
    """Make one rank's pool accounting diverge (the guard's test)."""
    if current_group().rank == rank:
        pool._free_pages.pop()


@mirrored()
def _raise_on(rank: Optional[int]) -> None:
    """An op that raises on ``rank`` only (None: on every rank)."""
    if rank is None or current_group().rank == rank:
        raise MemoryError(f"planted on rank {rank}")


def _one_rank_raises(group, rank: int, path: str) -> None:
    """Guard off: an op raising on every rank leaves the group serving,
    then one raising on ``rank`` alone; the controller writes what it got
    to ``path`` before the worker leaves with its error."""
    import torch.distributed as dist
    if not group.is_controller:
        try:
            group.serve()
        finally:
            dist.barrier(group=group.ctrl_group)
        return
    seen = []
    with pytest.raises(MemoryError):
        _raise_on(None)
    seen.append(group.gather(_worker_failures))
    try:
        _raise_on(rank)
        seen.append("no error")
    except DivergenceError as e:
        seen.append(str(e))
    Path(path).write_text(repr(seen))
    dist.barrier(group=group.ctrl_group)


def _faas_pass(group, fn, kv_dtype, tpl, reqs, pump: bool = False) -> dict:
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
    if pump:
        # deadlines through the pump thread: one arrived long ago (shed at
        # once), the others race the pump; none may hang
        from repro_torch.runtime.errors import DeadlineExceeded
        rt.gateway.start_pump()
        handles = [rt.submit(InvocationRequest(
            fn.name, reqs[0][1], max_new_tokens=NEW, deadline_s=1.0,
            arrival_s=time.perf_counter() - 10.0))]
        handles += [rt.submit(InvocationRequest(
            fn.name, p, max_new_tokens=NEW, deadline_s=d))
            for (_, p), d in zip(reqs, (60.0, 1e-4, 60.0, 1e-4))]
        status = []
        for h in handles:
            try:
                status.append(("done", h.result(timeout=120).tokens.tolist()))
            except DeadlineExceeded:
                status.append(("shed", None))
        rt.gateway.stop_pump()
        out["pump"] = status
    rt.evict()
    return out


def _pool_ops(group, model) -> dict:
    """A fixed operation sequence on a pool, the state on every rank."""
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
    states = group.gather(_pool_state, pool)
    # an op that raises on every rank: the controller's caller sees it,
    # the worker records it and keeps serving
    try:
        pool.alloc(40, 4, owner=owner)
        refused = None
    except ValueError as e:
        refused = str(e)
    failures = group.gather(_worker_failures)
    after = group.gather(_pool_state, pool)
    try:
        _forge_free_list(pool, 1)
        pool.alloc(4, 4, owner=owner)
        guard = "no error"
    except DivergenceError as e:
        guard = str(e)
    return {"slots": [s0, s1], "extended": ok, "states": states,
            "refused": refused, "failures": failures, "after": after,
            "guard": guard}


def _prefer_seq_decode(jax_params: dict, kv: int, prompt) -> dict:
    """On every rank: a prefill, then greedy decode steps, under the
    group's plan with ``prefer_seq``; the tokens, every step's logits, the
    calls of the slice and merge entries and one step's collectives."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    group = current_group()
    plan = dataclasses.replace(group.plan, prefer_seq=True)
    cfg = _cfg(kv)
    model = get_model(cfg, device="cpu", plan=plan)
    params = convert.params_from_jax(jax_params, cfg, device="cpu", plan=plan)
    calls = {"slice": 0, "merge": 0}
    real = ops.decode_attention_slice, ops.decode_merge_ranks

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call
    ops.decode_attention_slice = counted("slice", real[0])
    ops.decode_merge_ranks = counted("merge", real[1])
    try:
        cache = model.make_cache(1, MAX_LEN)
        logits, cache = model.prefill(params, {"tokens": prompt[None]}, cache)
        steps, tokens = [logits.numpy()], [int(logits.argmax(-1))]
        kinds = None
        for i in range(NEW - 1):
            sharding.reset_collective_stats()
            logits, cache = model.decode_step(
                params, cache, {"tokens": np.array([[tokens[-1]]], np.int32)},
                len(prompt) + i)
            kinds = sharding.collective_stats()["kinds"]
            steps.append(logits.numpy())
            tokens.append(int(logits.argmax(-1)))
    finally:
        ops.decode_attention_slice, ops.decode_merge_ranks = real
    return {"tokens": tokens, "logits": np.stack(steps), "calls": calls,
            "kinds": kinds, "cache_rows": int(cache["k"].shape[2])}


SPLIT_ARCHS = ("phi3.5-moe-42b-a6.6b", "zamba2-2.7b")


def _split_against_heads(arch: str) -> dict:
    """On every rank: the smoke ``arch`` (moe; zamba's shared attention
    block) decoding over a cache split by sequence and over the cache
    split by heads, from the same seeded weights: both steps' logits."""
    group = current_group()
    cfg = reduced(get_config(arch), dtype="float32")
    prompt = np.random.default_rng(2).integers(1, cfg.vocab_size, 9)
    out = {}
    for seq in (False, True):
        plan = dataclasses.replace(group.plan, prefer_seq=seq)
        model = get_model(cfg, device="cpu", plan=plan)
        params = model.init_params(seed=4)
        cache = model.make_cache(1, MAX_LEN)
        logits, cache = model.prefill(params, {"tokens": prompt[None]}, cache)
        steps = [logits.numpy()]
        for i in range(3):
            logits, cache = model.decode_step(
                params, cache, {"tokens": np.array(
                    [[int(steps[-1].argmax())]], np.int32)}, len(prompt) + i)
            steps.append(logits.numpy())
        out[seq] = np.stack(steps)
    return out


def _ranks(group, jax_params: dict) -> dict:
    """Every scenario, on every rank: the workers serve, the controller
    drives and returns what the tests check."""
    tpl, reqs = _workload()
    models, fns, params = {}, {}, {}
    for kv in KVS:
        cfg = _cfg(kv)
        models[kv] = get_model(cfg, device="cpu", plan=group.plan)
        params[kv] = group.bind(convert.params_from_jax(
            jax_params[kv], cfg, device="cpu", plan=group.plan))
        name = f"f{kv}".replace("/", "-")
        fns[kv] = group.bind(tidal.static_function(name, models[kv],
                                                   params[kv]))
    if not group.is_controller:
        try:
            group.serve()
        except DivergenceError:
            pass
        return None
    from repro_torch.runtime.engine import Engine
    out = {}
    for kv in KVS:
        m, p = models[kv], params[kv]
        r = {"fp": _faas_pass(group, fns[kv], None, tpl, reqs, pump=kv == 1),
             "int8": _faas_pass(group, fns[kv], "int8", tpl, reqs)}
        logits, _ = m.prefill(p, {"tokens": reqs[0][1][None]},
                              m.make_cache(1, MAX_LEN))
        r["logits"] = logits.numpy()
        batch = np.stack([reqs[0][1], reqs[0][1][::-1]])
        r["engine"] = Engine(m, p).generate(batch, NEW,
                                            cache_len=MAX_LEN).tokens
        r["prefer_seq"] = group.gather(_prefer_seq_decode, jax_params[kv], kv,
                                       reqs[0][1])
        out[kv] = r
    out["split"] = {a: group.gather(_split_against_heads, a)
                    for a in SPLIT_ARCHS}
    out["pool"] = _pool_ops(group, models[1])      # breaks the channel last
    return out


# ---------------------------------------------------------------------------
# the tests (JAX on this side only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    import jax
    from repro.models.registry import get_smoke_model as jax_smoke
    out = {}
    for kv in KVS:
        heads = _uneven_heads() if kv == UNEVEN else {"n_kv_heads": kv}
        jm = jax_smoke("smollm-135m", n_layers=2, **heads)
        jp = jm.init_params(jax.random.PRNGKey(3 if kv == UNEVEN else kv))
        out[kv] = (jm, jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def tp(jax_side):
    return spawn(_ranks, 2, ({kv: v[2] for kv, v in jax_side.items()},),
                 device="cpu", guard=True, timeout_s=600,
                 collective_timeout_s=120)


@pytest.fixture(scope="module")
def engine_tokens(jax_side):
    """The JAX single-device ``Engine``'s greedy tokens per prompt."""
    from repro.runtime.engine import Engine
    _, reqs = _workload()
    return {kv: [np.asarray(Engine(jm, jp).generate(
        prompt[None], max_new_tokens=NEW, cache_len=MAX_LEN).tokens[0]).tolist()
        for _, prompt in reqs] for kv, (jm, jp, _) in jax_side.items()}


@pytest.mark.parametrize("arena", ["fp", "int8"])
@pytest.mark.parametrize("kv", KVS)
def test_faas_kinds_and_tokens_match_the_jax_engine(tp, engine_tokens, kv,
                                                    arena):
    """Cold, fork (streamed), prefix hit and warm over the fp and the int8
    arena give the single-device JAX ``Engine``'s greedy tokens."""
    rows = tp[kv][arena]["requests"]
    assert [r["kind"] for r in rows] == ["cold", "fork", "warm", "warm"]
    assert rows[1]["streamed"] and rows[2]["reused"] > 0
    assert [r["tokens"] for r in rows] == engine_tokens[kv]


@pytest.mark.parametrize("kv", KVS)
def test_prefill_logits_within_fp32_tolerance(tp, jax_side, kv):
    import jax.numpy as jnp
    jm, jp, _ = jax_side[kv]
    _, reqs = _workload()
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(reqs[0][1][None])},
                         jm.make_cache(1, MAX_LEN))
    want = np.asarray(want)
    got = tp[kv]["logits"]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kv", KVS)
def test_sequential_engine_under_the_plan_matches_jax(tp, jax_side, kv):
    from repro.runtime.engine import Engine
    jm, jp, _ = jax_side[kv]
    _, reqs = _workload()
    batch = np.stack([reqs[0][1], reqs[0][1][::-1]])
    want = Engine(jm, jp).generate(batch, NEW, cache_len=MAX_LEN).tokens
    np.testing.assert_array_equal(tp[kv]["engine"], np.asarray(want))


@pytest.mark.parametrize("kv", KVS)
def test_prefer_seq_decode_matches_the_jax_decode_step(tp, jax_side, kv):
    """The cache split by sequence over the two ranks: greedy tokens equal
    the JAX ``prefill`` + ``decode_step``'s, every step's fp32 logits
    within 1e-5 of their largest, on both ranks alike; each layer of a
    step runs the slice and merge entries once and two ``all_gather``
    (q with the new K/V rows, then the ranks' (o, lse)) beside the
    one-device plan's 2L + 2 ``all_reduce``."""
    import jax.numpy as jnp
    jm, jp, _ = jax_side[kv]
    _, reqs = _workload()
    prompt = reqs[0][1]
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])},
                               jm.make_cache(1, MAX_LEN))
    want, toks = [np.asarray(logits)], [int(np.argmax(logits))]
    for i in range(NEW - 1):
        logits, cache = jm.decode_step(
            jp, cache, {"tokens": jnp.asarray([[toks[-1]]], jnp.int32)},
            len(prompt) + i)
        want.append(np.asarray(logits))
        toks.append(int(np.argmax(logits)))
    want = np.stack(want)
    ranks = tp[kv]["prefer_seq"]
    L = 2
    for got in ranks:
        assert got["tokens"] == toks
        assert np.abs(got["logits"] - want).max() <= 1e-5 * np.abs(want).max()
        assert got["cache_rows"] == MAX_LEN // 2
        assert got["calls"] == {"slice": L * (NEW - 1),
                                "merge": L * (NEW - 1)}
        assert got["kinds"] == {"all_reduce": 2 * L + 2, "all_gather": 2 * L}


@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_prefer_seq_decode_equals_the_head_split_decode(tp, arch):
    """The moe family and zamba's shared attention block over a cache
    split by sequence give the logits of the same weights over the cache
    split by heads (held against the JAX package elsewhere), within 1e-5
    of the largest, on both ranks."""
    for got in tp["split"][arch]:
        seq, heads = got[True], got[False]
        assert np.abs(seq - heads).max() <= 1e-5 * np.abs(heads).max()


@pytest.mark.parametrize("kv", KVS)
def test_fork_bytes_per_rank_sum_to_one_device_plus_replicas(tp, jax_side, kv):
    """Each rank streams its shard: the ranks' bytes add up to the
    one-device fork's plus every replicated leaf once more (tp - 1)."""
    from repro_torch.runtime import FaaSRuntime
    cfg = _cfg(kv)
    model = get_model(cfg, device="cpu")
    params = convert.params_from_jax(jax_side[kv][2], cfg, device="cpu")
    rt = FaaSRuntime(device="cpu", n_slots=2, max_len=MAX_LEN, page_size=PS,
                     trace_seq=8, prewarm=False)
    rt.deploy(tidal.static_function("one", model, params), {})
    _, one = rt.server.fork("one", {})
    for row in tp[kv]["fp"]["requests"][:2]:
        streamed, reused, replicated = zip(*row["fork"])
        assert len(set(replicated)) == 1 and replicated[0] > 0
        assert sum(streamed) + sum(reused) == (
            one.streamed_bytes + one.reused_bytes + replicated[0])
        if kv == UNEVEN:                     # rank 0 holds 6 of 9 heads
            assert streamed[0] + reused[0] > streamed[1] + reused[1]
        else:
            assert len(set(streamed)) == 1   # equal shards


def test_pool_accounting_identical_on_ranks_and_equal_to_jax(tp, jax_side):
    from repro.runtime.kv_pool import PagedKVCachePool
    jm = jax_side[1][0]
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
    want = _pool_state(pool)
    got = tp["pool"]
    assert got["slots"] == [s0, s1] and got["extended"] == ok
    assert got["states"][0] == got["states"][1]
    assert tuple(got["states"][0]) == want


def test_an_op_raising_on_every_rank_keeps_the_group_serving(tp):
    """A request larger than a slot raises in the pool on both ranks: the
    controller's caller gets the error, the worker records it, and the
    next ops run on unchanged, identical state."""
    pool = tp["pool"]
    assert "pages but a slot's page table holds" in pool["refused"]
    assert pool["failures"] == [0, 1]
    assert pool["after"][0] == pool["after"][1] == pool["states"][0]


def test_deadlines_through_the_pump_thread_end(tp):
    status = tp[1]["fp"]["pump"]
    assert len(status) == 5
    assert status[0] == ("shed", None)
    assert [s for s, _ in status].count("done") >= 1
    done = dict(zip(("p0", "p1", "hit", "warm"), status[1:]))
    first = tp[1]["fp"]["requests"][0]["tokens"]
    for key in ("p0", "warm"):
        if done[key][0] == "done":
            assert done[key][1] == first


def test_divergence_guard_raises_on_a_forged_pool(tp):
    assert "diverged before running" in tp["pool"]["guard"]


@pytest.mark.parametrize("rank", [0, 1])
def test_an_op_raising_on_one_rank_fails_every_rank(rank, tmp_path):
    """Guard off: the raise on every rank keeps the worker serving (it
    records it); the raise on one rank alone gives the controller a
    ``DivergenceError`` naming the planted error, and the worker leaves
    its loop with one, which ``spawn`` reports."""
    path = tmp_path / "controller.txt"
    with pytest.raises(RuntimeError) as info:
        spawn(_one_rank_raises, 2, (rank, str(path)), device="cpu",
              guard=False, timeout_s=300, collective_timeout_s=60)
    failures, controller = eval(path.read_text())
    assert failures == [0, 1]
    assert "ended differently on the ranks" in controller
    assert f"rank {rank} raised" in controller
    assert f"MemoryError: planted on rank {rank}" in controller
    assert "rank 1:" in str(info.value)
    assert "DivergenceError" in str(info.value)


def test_pool_counts_return_after_the_drain(tp):
    for kv in KVS:
        for arena in ("fp", "int8"):
            (stats,) = tp[kv][arena]["pool"].values()
            assert stats["n_free_slots"] == 2


def test_serve_cli_tp2_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--tp", "2", "--layers", "2", "--functions", "2", "--requests", "10",
         "--prompt-len", "16", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [l for l in res.stdout.splitlines() if l.startswith("req")]
    assert len(lines) == 10
    # forks under the plan: test_faas_kinds_and_tokens_match_the_jax_engine
    assert {l.split()[2] for l in lines} == {"cold", "warm"}
    assert "2 ranks" in res.stdout and "gloo" in res.stdout
