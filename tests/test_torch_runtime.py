"""The port's serving runtime, held against the JAX runtime on the CPU.

The same operation trace goes through both ``PagedKVCachePool``s (page
tables, refcounts, free counts and stats must be identical), both
``PrefixIndex``es, and both ``ContinuousBatchingEngine``s (the JAX one
with ``attn_impl="pallas"``): mixed prompt lengths, a prefix hit with a
copy-on-write partial page, chunked prefill, an int8 arena, a cancel, a
deadline shed and one sampled (temperature > 0) request must give the
same statuses and tokens.  Smoke configs, 2 layers, fp32, TF32 off.
"""

import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro.runtime.continuous import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.runtime.kv_pool import PagedKVCachePool as JaxPool  # noqa: E402
from repro.runtime.prefix import PrefixIndex as JaxIndex  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402
from repro_torch.runtime import (ContinuousBatchingEngine, PagedKVCachePool,  # noqa: E402
                                 PartitionViolation, PoolExhausted, PrefixIndex)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
PS = 4
MAX_LEN = 48


@pytest.fixture(scope="module")
def models():
    jm = jax_smoke("smollm-135m", n_layers=2, attn_impl="pallas")
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=2)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return jm, jp, tm, tp


def _state(pool):
    return {"page_table": np.asarray(pool.page_table).copy(),
            "refs": np.asarray(pool._page_refs).copy(),
            "free_pages": pool.n_free_pages,
            "available": pool.n_available_pages,
            "free_slots": pool.n_free_slots,
            "stats": dict(pool.stats), "peak": pool.peak_used_pages,
            "used": pool.n_used_pages}


def _assert_same_state(jp, tp):
    a, b = _state(jp), _state(tp)
    np.testing.assert_array_equal(a.pop("page_table"), b.pop("page_table"))
    np.testing.assert_array_equal(a.pop("refs"), b.pop("refs"))
    assert a == b


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pool_trace_replays_identically(models, kv_dtype):
    jm, _, tm, _ = models
    jpool = JaxPool(jm, n_slots=4, max_len=32, page_size=PS, n_pages=20,
                    kv_dtype=kv_dtype)
    tpool = PagedKVCachePool(tm, n_slots=4, max_len=32, page_size=PS,
                             n_pages=20, kv_dtype=kv_dtype)
    rng = np.random.default_rng(0)
    L, KV, hd = tm.cfg.n_layers, tm.cfg.n_kv_heads, tm.cfg.head_dim
    sub = {k: rng.standard_normal((L, 1, 32, KV, hd)).astype(np.float32)
           for k in ("k", "v")}
    jsub = {k: jnp.asarray(v) for k, v in sub.items()}
    tsub = {k: torch.from_numpy(v) for k, v in sub.items()}
    prefix = rng.integers(0, 256, 10).astype(np.int32)     # 2 pages + 2 rows

    def both(op):
        rj, rt = op(jpool, jsub), op(tpool, tsub)
        _assert_same_state(jpool, tpool)
        return rj, rt

    oa = both(lambda p, s: p.register_owner("a"))
    ob = both(lambda p, s: p.register_owner("b"))
    assert oa[0] == oa[1] and ob[0] == ob[1]
    s0 = both(lambda p, s: p.alloc(9, 4, owner=oa[0]))
    assert s0[0] == s0[1]
    both(lambda p, s: p.write_prompt(s0[0], s, 9, owner=oa[0]))
    hj, ht = both(lambda p, s: p.bake_prefix(s, prefix))
    assert hj.pages == ht.pages
    s1 = (jpool.alloc(14, 6, shared_prefix=hj, reuse_len=10, owner=ob[0]),
          tpool.alloc(14, 6, shared_prefix=ht, reuse_len=10, owner=ob[0]))
    _assert_same_state(jpool, tpool)
    assert s1[0] == s1[1] and jpool.prefix_page_refs(hj) == tpool.prefix_page_refs(ht)
    both(lambda p, s: p.write_suffix(s1[0], s, 10, 14, owner=ob[0]))
    s2 = both(lambda p, s: p.alloc(20, 8, budget_tokens=8, owner=oa[0]))
    assert both(lambda p, s: p.extend_budget(s2[0], 16, owner=oa[0])) == (True, True)
    assert both(lambda p, s: p.extend_budget(s2[0], 28, owner=oa[0])) == (True, True)
    both(lambda p, s: p.alloc(8, 0, owner=ob[0]))       # the last free pages
    assert both(lambda p, s: p.extend_budget(s2[0], 32, owner=oa[0])) == (False, False)
    both(lambda p, s: p.ensure_len(s2[0], 13, owner=oa[0]))
    for owner in (oa[0], ob[0], None):
        np.testing.assert_array_equal(
            np.asarray(jpool.device_page_table(owner)),
            tpool.device_page_table(owner).numpy())
    assert jpool.partition_stats(oa[0]) == tpool.partition_stats(oa[0])
    with pytest.raises(PartitionViolation):
        tpool.release(s1[1], owner=oa[1])
    with pytest.raises(PoolExhausted):
        tpool.alloc(28, 4)
    both(lambda p, s: p.release(s1[0], owner=ob[0]))
    both(lambda p, s: p.release_prefix(hj if p is jpool else ht))
    both(lambda p, s: p.release_owner(oa[0]))
    # the arenas hold the same values (and int8 scales) page for page
    for key, arena in tpool.cache.items():
        np.testing.assert_allclose(arena.numpy(), np.asarray(jpool.cache[key]),
                                   atol=1e-6)
    for a, b in zip(jax.tree.leaves(jpool.read_slot(s0[0], 9)),
                    (tpool.read_slot(s0[1], 9)[k] for k in ("k", "v"))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_prefix_index_match_agrees(models):
    jm, _, tm, _ = models
    jpool = JaxPool(jm, n_slots=2, max_len=32, page_size=PS)
    tpool = PagedKVCachePool(tm, n_slots=2, max_len=32, page_size=PS)
    jz = jm.make_cache(1, 16)
    tz = tm.make_cache(1, 16)
    prefixes = [np.arange(8, dtype=np.int32), np.arange(14, dtype=np.int32),
                np.arange(3, 7, dtype=np.int32)]
    jidx, tidx = JaxIndex(PS), PrefixIndex(PS)
    jh = [jpool.bake_prefix(jz, p) for p in prefixes]
    th = [tpool.bake_prefix(tz, p) for p in prefixes]
    for a, b in zip(jh, th):
        jidx.register(a)
        tidx.register(b)
    jidx.unregister(jh[0])
    tidx.unregister(th[0])
    prompts = [np.arange(20, dtype=np.int32), np.arange(9, dtype=np.int32),
               np.arange(14, dtype=np.int32), np.arange(3, 12, dtype=np.int32),
               np.array([5, 6, 7, 8, 9], np.int32)]
    for p in prompts:
        a, b = jidx.match(p), tidx.match(p)
        assert (a is None) == (b is None)
        if a is not None:
            assert jh.index(a[0]) == th.index(b[0]) and a[1] == b[1]


def _drive(engine_cls, pool_cls, index_cls, m, params, kv_dtype, chunk,
           bucket, prefill):
    """One scripted request trace; returns statuses, tokens and stats."""
    pool = pool_cls(m, n_slots=3, max_len=MAX_LEN, page_size=PS,
                    kv_dtype=kv_dtype)
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, 256, 13).astype(np.int32)      # partial tail
    handle = pool.bake_prefix(prefill(m, params, prefix, pool.padded_len),
                              prefix)
    index = index_cls(PS)
    index.register(handle)
    eng = engine_cls(m, params, pool=pool, prefix_index=index,
                     chunk_tokens=chunk, bucket_suffix=bucket)
    rand = [rng.integers(1, 256, n).astype(np.int32) for n in (21, 4, 17, 9, 6)]
    ids = [
        eng.submit(np.concatenate([prefix, rand[4]]), 5),          # prefix hit
        eng.submit(rand[0], 6),
        eng.submit(rand[1], 4, temperature=0.8, top_p=0.9, seed=7),
        eng.submit(rand[2], 3),                                    # cancelled
        eng.submit(rand[3], 3, submit_s=time.perf_counter() - 10.0,
                   deadline_s=1.0),                                # shed
        eng.submit(np.concatenate([prefix, rand[0][:9]]), 4, priority=1),
    ]
    eng.step()
    cancelled = eng.cancel(ids[3])
    res = eng.run()
    out = {"cancelled": cancelled, "stats": dict(pool.stats),
           "free_pages": pool.n_free_pages}
    for i in ids:
        r = res[i]
        out[i] = (r.status, r.tokens.tolist(), r.reused_prefix_len)
    eng.close()
    return out


def _jax_prefill(m, params, toks, length):
    _, cache = m.prefill(params, {"tokens": jnp.asarray(toks[None])},
                         m.make_cache(1, length))
    return cache


def _torch_prefill(m, params, toks, length):
    _, cache = m.prefill(params, {"tokens": toks[None]}, m.make_cache(1, length))
    return cache


@pytest.mark.parametrize("kv_dtype,chunk,bucket", [
    (None, None, False),     # partial-page COW reuse, whole-prompt prefill
    (None, None, True),      # reuse shrunk to a page-multiple suffix
    ("int8", 8, False),      # int8 arena, chunked prefill
])
def test_engine_matches_jax_engine(models, kv_dtype, chunk, bucket):
    jm, jp, tm, tp = models
    want = _drive(JaxEngine, JaxPool, JaxIndex, jm, jp, kv_dtype, chunk,
                  bucket, _jax_prefill)
    got = _drive(ContinuousBatchingEngine, PagedKVCachePool, PrefixIndex, tm,
                 tp, kv_dtype, chunk, bucket, _torch_prefill)
    assert got == want
    statuses = [got[i][0] for i in range(6)]
    assert statuses == ["done", "done", "done", "cancelled", "shed", "done"]
    assert got[0][2] > 0 and got[5][2] > 0                  # prefix hits


def test_engine_counts_steps_and_prefills(models):
    _, _, tm, tp = models
    eng = ContinuousBatchingEngine(tm, tp, n_slots=2, max_len=32, page_size=PS,
                                   chunk_tokens=8)
    rng = np.random.default_rng(2)
    for n in (5, 19):
        eng.submit(rng.integers(1, 256, n).astype(np.int32), 3)
    eng.run()
    # 5 tokens: one prefill; 19 tokens: chunks of 8, 8 and a final 4->8
    assert eng.n_prefill_calls == 4
    assert eng.n_decode_steps >= 2


def test_engine_raises_for_later_slices(models):
    _, _, tm, tp = models
    # forked sessions are served now; anything else is refused
    with pytest.raises(TypeError, match="ForkSession"):
        ContinuousBatchingEngine(tm, object(), n_slots=1, max_len=16)
    # a sharding plan serves the dense and moe families, and an adapter
    # bank under it (the rank's shard); zamba and xLSTM under a plan too,
    # over the dense pool; whisper builds under a plan, but the
    # sequential Engine, which serves enc-dec, takes no plan
    from repro_torch.distributed import ServingMesh, serving_plan
    from repro_torch.models.adapters import make_adapter_bank
    plan = serving_plan(ServingMesh(1, 2), rank=0)
    zamba = torch_smoke("zamba2-2.7b", device="cpu", plan=plan)
    zeng = ContinuousBatchingEngine(zamba, zamba.init_params(), n_slots=1,
                                    max_len=16, plan=plan)
    assert not zeng.paged
    assert zeng.pool.cache["mamba"]["h"].shape[2] == zamba.cfg.ssm_heads // 2
    from repro_torch.runtime.engine import Engine
    whisper = torch_smoke("whisper-medium", device="cpu", plan=plan)
    with pytest.raises(NotImplementedError, match="sequential Engine"):
        Engine(whisper, whisper.init_params())
    sharded = torch_smoke("smollm-135m", device="cpu", n_layers=2, plan=plan)
    bank = make_adapter_bank(sharded, ("blocks.attn.wq", "blocks.attn.wo"),
                             3, 4)
    eng = ContinuousBatchingEngine(sharded, tp, n_slots=1, max_len=16,
                                   plan=plan, adapter_bank=bank)
    cfg, local = sharded.cfg, sharded.local_cfg
    assert eng.adapter_bank is bank
    assert tuple(bank["wq"]["b"].shape) == (2, 3, 4, local.n_heads
                                            * cfg.head_dim)
    assert tuple(bank["wo"]["a"].shape) == (2, 3, local.n_heads
                                            * cfg.head_dim, 4)
    assert local.n_heads * 2 == cfg.n_heads
