"""Dense-cache decode of the port, held against the JAX package on the CPU.

The plain ``decode_attention`` against the Pallas kernel (interpret mode)
within 2e-5; ``decode_step`` over a dense cache against the JAX ``Model``
(``attn_impl="pallas"``) within 2e-4; the sequential ``Engine`` and the
``paged=False`` continuous engine give the JAX engines' greedy tokens;
the dense ``KVCachePool`` hands out the same slots.  Smoke configs,
2 layers, fp32; weights carried by ``convert.params_from_jax``.  On a card
the dense decode runs the ``decode_attention`` kernel, never the plain
``_sdpa``: the dispatch test shows the layer goes through ``ops``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro.runtime.continuous import ContinuousBatchingEngine as JaxCBE  # noqa: E402
from repro.runtime.engine import Engine as JaxEngine  # noqa: E402
from repro.runtime.kv_pool import KVCachePool as JaxPool  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402
from repro_torch.runtime import (ContinuousBatchingEngine, Engine,  # noqa: E402
                                 KVCachePool, PoolExhausted)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ARCHS = ["smollm-135m", "qwen3-14b", "qwen2.5-32b", "gemma-2b", "llama3-8b",
         "llama2-13b", "chameleon-34b", "llama2-70b"]


def _pair(arch):
    jm = jax_smoke(arch, n_layers=2, attn_impl="pallas")
    tm = torch_smoke(arch, device="cpu", n_layers=2)
    jp = jm.init_params(jax.random.PRNGKey(0))
    if jm.cfg.qkv_bias:
        # zero-initialized biases would not exercise the bias path
        rng = np.random.default_rng(1)
        for k in ("bq", "bk", "bv"):
            b = jp["blocks"]["attn"][k]
            jp["blocks"]["attn"][k] = jnp.asarray(
                rng.standard_normal(b.shape).astype(np.float32) * 0.1)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("per_seq", [False, True])
def test_plain_decode_attention_matches_pallas(G, per_seq):
    rng = np.random.default_rng(G)
    B, KV, T, d = 3, 2, 64, 16
    q = rng.standard_normal((B, G * KV, d)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    length = np.asarray([1, 37, 64], np.int32) if per_seq else 45
    want = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(length), block_k=16, interpret=True)
    # the port hands the kernel its [B, T, KV, d] cache as a strided view
    cache_k = torch.from_numpy(k).transpose(1, 2).contiguous()
    cache_v = torch.from_numpy(v).transpose(1, 2).contiguous()
    got = ops.decode_attention(torch.from_numpy(q), cache_k.transpose(1, 2),
                               cache_v.transpose(1, 2), torch.as_tensor(length))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_decode_step_matches_jax(arch):
    """Prefill, then a dense decode step at a scalar position and one at
    per-sequence positions, within 2e-4 of the JAX model."""
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(4)
    B, S, T = 2, 8, 16
    toks = rng.integers(0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.make_cache(B, T))
    tl, tc = tm.prefill(tp, {"tokens": toks}, tm.make_cache(B, T))
    for pos in (S, np.asarray([S + 1, S - 2], np.int32)):
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(nxt)},
                                jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, {"tokens": nxt}, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    prompts = np.random.default_rng(0).integers(
        0, jm.cfg.vocab_size, (2, 8)).astype(np.int32)
    want = JaxEngine(jm, jp).generate(prompts, max_new_tokens=8)
    streamed = []
    got = Engine(tm, tp).generate(prompts, max_new_tokens=8,
                                  on_token=lambda t, i: streamed.append(t))
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(np.stack(streamed, 1), got.tokens)
    assert got.n_generated == 8 and got.n_prompt == 8


def test_engine_sampling_draws_from_its_generator():
    _, _, tm, tp = _pair("smollm-135m")
    prompts = np.zeros((2, 4), np.int32)
    a = Engine(tm, tp).generate(prompts, 6, greedy=False, seed=3)
    b = Engine(tm, tp).generate(prompts, 6, greedy=False, seed=3)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert ((a.tokens >= 0) & (a.tokens < tm.cfg.vocab_size)).all()


def test_dense_pool_slot_trace_matches_jax():
    jm, _, tm, _ = _pair("smollm-135m")
    jpool, tpool = JaxPool(jm, 3, 16), KVCachePool(tm, 3, 16)
    trace = []
    for op in ["a", "a", "r1", "a", "a", "r0", "r2", "a", "r1", "a"]:
        if op == "a":
            got = (jpool.alloc(), tpool.alloc())
        else:
            slot = int(op[1])
            got = (jpool.release(slot), tpool.release(slot))
        assert got[0] == got[1]
        assert jpool.n_free == tpool.n_free
        trace.append(tpool.n_free)
    assert trace == [2, 1, 2, 1, 0, 1, 2, 1, 2, 1]
    tpool.alloc()
    with pytest.raises(PoolExhausted):
        tpool.alloc()
    with pytest.raises(ValueError):
        tpool.release(7)
    sub = tm.make_cache(1, 16)
    sub["k"].normal_()
    tpool.write_slot(2, sub)
    assert torch.equal(tpool.read_slot(2)["k"], sub["k"])


def test_continuous_dense_pool_matches_jax():
    """``paged=False`` over ``KVCachePool``: a mixed trace (more requests
    than slots, varied lengths, a cancel and a sampled request) gives the
    JAX engine's statuses and tokens."""
    jm, jp, tm, tp = _pair("smollm-135m")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n in (5, 12, 3, 9, 7)]
    outs = []
    for eng in (JaxCBE(jm, jp, n_slots=2, max_len=24, paged=False),
                ContinuousBatchingEngine(tm, tp, n_slots=2, max_len=24,
                                         paged=False)):
        ids = [eng.submit(p, 5 + i % 3, temperature=0.7 if i == 3 else 0.0,
                          seed=11) for i, p in enumerate(prompts)]
        eng.step()
        eng.cancel(ids[4])
        res = eng.run()
        outs.append([(res[i].status, res[i].tokens.tolist()) for i in ids])
        assert eng.pool.n_free == 2
    assert outs[0] == outs[1]
    assert [s for s, _ in outs[1]] == ["done"] * 4 + ["cancelled"]


def test_dense_decode_dispatches_to_the_kernel(monkeypatch):
    """Every layer's dense decode goes through ``ops.decode_attention``
    (the kernel on a card) with ``length = pos + 1``, and never reaches
    the plain ``_sdpa``."""
    _, _, tm, tp = _pair("smollm-135m")
    calls = []
    real = ops.decode_attention

    def spy(q, k, v, length):
        calls.append(torch.as_tensor(length).tolist())
        return real(q, k, v, length)

    def no_sdpa(*a, **kw):
        raise AssertionError("dense decode reached the plain _sdpa")

    monkeypatch.setattr(ops, "decode_attention", spy)
    monkeypatch.setattr(layers, "_sdpa", no_sdpa)
    cache = tm.make_cache(2, 16)
    tm.prefill(tp, {"tokens": np.ones((2, 6), np.int32)}, cache)
    tm.decode_step(tp, cache, {"tokens": np.ones((2, 1), np.int32)},
                   np.asarray([6, 4], np.int32))
    assert calls == [[7, 5]] * tm.cfg.n_layers


@pytest.mark.parametrize("step", ["paged", "dense"])
def test_decode_with_a_logit_softcap_raises(step):
    """Neither decode kernel has a logit softcap (no config of the port
    sets one): a smoke config with ``attn_logit_softcap=30.0`` raises at
    the paged and the dense decode step alike, where the reference caps
    the scores, instead of dropping the cap without a word."""
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=2,
                     attn_logit_softcap=30.0)
    params = tm.init_params(seed=0)
    toks = {"tokens": np.ones((2, 1), np.int32)}
    pos = np.asarray([3, 1], np.int32)
    with pytest.raises(NotImplementedError, match="no logit softcap"):
        if step == "paged":
            tm.decode_step_paged(params, tm.make_paged_cache(5, 4), toks, pos,
                                 np.asarray([[1, 2], [3, 4]], np.int32), 4)
        else:
            tm.decode_step(params, tm.make_cache(2, 8), toks, pos)
