"""The port's moe family, held against the JAX package on the CPU.

``repro_torch.models.moe.moe_block`` against ``repro.models.moe.moe_block``
(dropless, capacity factor 1.25 and 0.5 with tokens dropped, tied router
probabilities); ``expert_capacity`` over a grid of token counts; the
phi3.5-moe smoke model's prefill, ``prefill_from`` and paged decode (fp
and int8) against the JAX ``Model``; the paged continuous engines of both
packages (greedy tokens equal, dropless and with tokens dropped at
decode), chunked prefill (dropless, and at cf 1.25 with pairs dropped
in the chunks) and prefix reuse; streamed prefill and the
traced access order.  Weights carried by ``convert.params_from_jax``;
smoke configs at 2 layers, fp32, TF32 off.  Tolerance: 2e-4 on logits
and expert outputs, as in tests/test_torch_models.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.tracing import trace_weight_access as jax_trace  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import quant as jquant  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro.runtime.continuous import ContinuousBatchingEngine as JaxCBE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tidal  # noqa: E402
from repro_torch.core.streaming import streamed_prefill  # noqa: E402
from repro_torch.core.template_server import TemplateServer  # noqa: E402
from repro_torch.core.tracing import coverage, trace_weight_access  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402
from repro_torch.runtime import (ContinuousBatchingEngine, Engine,  # noqa: E402
                                 PagedKVCachePool, PrefixIndex)

torch.backends.cuda.matmul.allow_tf32 = False
ARCH = "phi3.5-moe-42b-a6.6b"
ATOL = 2e-4
ROOT = Path(__file__).resolve().parent.parent
_PAIRS: dict = {}


def _pair(cf=None):
    """JAX and port smoke models (2 layers; ``cf`` forces the capacity
    factor, else the smoke config's dropless E/K) with the same weights."""
    if cf not in _PAIRS:
        extra = {} if cf is None else {"capacity_factor": cf}
        jm = jax_smoke(ARCH, n_layers=2, **extra)
        tm = torch_smoke(ARCH, device="cpu", n_layers=2, **extra)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                     device="cpu")
        _PAIRS[cf] = (jm, jp, tm, tp)
    return _PAIRS[cf]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=0)


def _jax_routing(p, x, cfg):
    """The reference's expert ids [T, K] (``repro.models.moe``'s router)."""
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, p["router"])
                           .astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])


# ---------------------------------------------------------------------------
# the expert layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [None, 1.25, 0.5],
                         ids=["dropless", "cf1.25", "cf0.5"])
def test_moe_block_matches_jax(cf):
    """Routing equal, outputs within 2e-4.  Half the rows repeat one token
    (as free slots' rows do in a decode step), so cf 1.25 and cf 0.5 drop
    pairs; the smoke config's cf = E/K drops none."""
    jm, jp, tm, tp = _pair(cf)
    x = np.random.default_rng(7).standard_normal(
        (2, 32, tm.cfg.d_model)).astype(np.float32)
    x[:, 16:] = x[0, 0]
    jblk = jax.tree.map(lambda a: a[1], jp["blocks"]["moe"])
    tblk = tp["layers"][1]["moe"]
    want = jmoe.moe_block(jblk, jnp.asarray(x), jm.cfg)
    with moe.watch() as calls:
        got = moe.moe_block(tblk, torch.from_numpy(x), tm.cfg)
    _close(got, want)
    [(S, idx, keep)] = calls
    assert S == x.shape[1]
    np.testing.assert_array_equal(idx.numpy(), _jax_routing(jblk, x, jm.cfg))
    dropped = int((~keep).sum())
    assert (dropped > 0) == (cf is not None), dropped


def test_tied_router_probabilities_break_to_the_lower_index():
    """Integer inputs and router weights make many router logits exactly
    equal: the port picks the reference's experts (lower index first)."""
    jm, jp, tm, tp = _pair(1.25)
    rng = np.random.default_rng(8)
    D, E = tm.cfg.d_model, tm.cfg.n_experts
    x = rng.integers(-1, 2, (1, 64, D)).astype(np.float32)
    router = rng.integers(-1, 2, (D, E)).astype(np.float32)
    router[:, 3] = router[:, 1]                 # whole columns tied too
    router[:, 6] = router[:, 2]
    jblk = dict(jax.tree.map(lambda a: a[0], jp["blocks"]["moe"]),
                router=jnp.asarray(router))
    tblk = dict(tp["layers"][0]["moe"], router=torch.from_numpy(router))
    want_idx = _jax_routing(jblk, x, jm.cfg)
    _, idx = moe.route(tblk, torch.from_numpy(x).reshape(-1, D), tm.cfg)
    logits = x.reshape(-1, D) @ router
    top2 = np.sort(logits, axis=-1)[:, -2:]
    assert (top2[:, 0] == top2[:, 1]).sum() > 8       # ties at the top 2
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert (idx[:, 0] < idx[:, 1])[logits.max(-1) == top2[:, 0]].all()
    _close(moe.moe_block(tblk, torch.from_numpy(x), tm.cfg),
           jmoe.moe_block(jblk, jnp.asarray(x), jm.cfg))


def test_expert_capacity_matches_jax():
    for cf in (0.5, 1.0, 1.25, 4.0):
        jm, _, tm, _ = _pair(None)
        jc, tc = jm.cfg.replace(capacity_factor=cf), tm.cfg.replace(
            capacity_factor=cf)
        for T in list(range(1, 70)) + [127, 128, 129, 511, 512, 4096]:
            assert moe.expert_capacity(T, tc) == jmoe.expert_capacity(T, jc), (
                cf, T)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefill_and_paged_decode_match_jax(kv_dtype):
    """prefill, prefill_from, then 6 greedy decode_step_paged steps over a
    shuffled page arena (fp, or int8 quantized on append)."""
    jm, jp, tm, tp = _pair()
    B, PS, NB, S, pre = 2, 8, 4, 13, 8
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.make_cache(B, NB * PS))
    tl, tc = tm.prefill(tp, {"tokens": toks}, tm.make_cache(B, NB * PS))
    _close(tl, jl)
    _, tc2 = tm.prefill(tp, {"tokens": toks[:, :pre]}, tm.make_cache(B, NB * PS))
    _, jc2 = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :pre])},
                        jm.make_cache(B, NB * PS))
    jl2, _ = jm.prefill_from(jp, {"tokens": jnp.asarray(toks[:, pre:])}, jc2, pre)
    tl2, _ = tm.prefill_from(tp, {"tokens": toks[:, pre:]}, tc2, pre)
    _close(tl2, jl2)

    pt = (rng.permutation(B * NB) + 1).reshape(B, NB).astype(np.int32)
    arena = {}
    for k in ("k", "v"):
        dense = np.asarray(jc[k]).reshape((jm.cfg.n_layers, B, NB, PS)
                                          + jc[k].shape[3:])
        a = np.zeros((jm.cfg.n_layers, 1 + B * NB, PS) + jc[k].shape[3:],
                     np.float32)
        for b in range(B):
            for j in range(NB):
                a[:, pt[b, j]] = dense[:, b, j]
        arena[k] = a
    if kv_dtype == "int8":
        for k in ("k", "v"):
            q, s = jquant.quantize_rows(jnp.asarray(arena[k]))
            arena[k], arena[k + "_scale"] = np.asarray(q), np.asarray(s)
    ja = {k: jnp.asarray(v) for k, v in arena.items()}
    ta = {k: torch.from_numpy(v.copy()) for k, v in arena.items()}
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    for _ in range(6):
        jl, ja = jm.decode_step_paged(jp, ja, {"tokens": jnp.asarray(tok)},
                                      jnp.asarray(pos), jnp.asarray(pt), PS)
        tl, ta = tm.decode_step_paged(tp, ta, {"tokens": tok}, pos, pt, PS)
        _close(tl, jl)
        jt = np.argmax(np.asarray(jl), -1)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jt)
        tok, pos = jt.astype(np.int32)[:, None], pos + 1


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(vocab, seed, spec):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, n).astype(np.int32), mn) for n, mn in spec]


def _serve(engine, reqs):
    ids = [engine.submit(p, mn) for p, mn in reqs]
    out = engine.run()
    return [out[i].tokens for i in ids]


def _dropped(calls) -> dict:
    """The (token, k) pairs the watched expert layers dropped, split by
    prefill (S > 1) and decode (S == 1) calls."""
    counts = {"prefill": 0, "decode": 0}
    for S, _, keep in calls:
        counts["decode" if S == 1 else "prefill"] += int((~keep).sum())
    return counts


@pytest.mark.parametrize("n_slots,cf,chunk",
                         [(2, None, None), (8, 1.25, None), (8, 1.25, 8),
                          (8, 1.25, 12)],
                         ids=["2slots-dropless", "8slots-cf1.25",
                              "8slots-cf1.25-chunk8", "8slots-cf1.25-chunk12"])
def test_paged_engine_tokens_match_jax(n_slots, cf, chunk):
    """Greedy tokens of the port's paged engine equal the JAX engine's.
    At 8 slots and cf 1.25 a decode step of T = 8 rows has capacity 4, so
    pairs are dropped (free slots' rows count too) and both engines must
    drop the same ones; with chunked prefill each chunk is a call of its
    own T, so chunking changes which prefill pairs are dropped."""
    jm, jp, tm, tp = _pair(cf)
    spec = ((21, 9), (4, 12), (17, 6), (9, 10), (30, 5))[:5 if n_slots == 8
                                                         else 3]
    reqs = _requests(tm.cfg.vocab_size, 11, spec)
    want = _serve(JaxCBE(jm, jp, n_slots=n_slots, max_len=48, page_size=4,
                         chunk_tokens=chunk, donate_cache=False), reqs)
    eng = ContinuousBatchingEngine(tm, tp, n_slots=n_slots, max_len=48,
                                   page_size=4, chunk_tokens=chunk)
    assert eng.paged
    with moe.watch() as calls:
        got = _serve(eng, reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    drops = _dropped(calls)
    assert (drops["decode"] > 0) == (cf is not None), drops
    assert drops["prefill"] == 0 or cf is not None
    assert drops["prefill"] > 0 or chunk is None, drops


def test_chunked_prefill_and_prefix_reuse_match_jax():
    """Chunked prefill (page and non-page chunk sizes) and a baked prefix
    with a copy-on-write partial page give the sequential Engine's tokens
    (dropless smoke config: T changes with chunking, routing does not
    drop), and the JAX engine's for the same run."""
    jm, jp, tm, tp = _pair()
    PS, MAX = 4, 40
    reqs = _requests(tm.cfg.vocab_size, 0, ((21, 5), (4, 6), (17, 3), (9, 4)))
    seq = Engine(tm, tp)
    want = [seq.generate(p[None], max_new_tokens=n, cache_len=MAX).tokens[0]
            for p, n in reqs]
    for chunk in (None, PS, 7):
        got = _serve(ContinuousBatchingEngine(tm, tp, n_slots=3, max_len=MAX,
                                              page_size=PS, chunk_tokens=chunk),
                     reqs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    jwant = _serve(JaxCBE(jm, jp, n_slots=3, max_len=MAX, page_size=PS,
                          chunk_tokens=PS, donate_cache=False), reqs)
    for g, w in zip(jwant, want):
        np.testing.assert_array_equal(g, w)

    prefix = np.random.default_rng(1).integers(1, tm.cfg.vocab_size, 13
                                               ).astype(np.int32)
    rng = np.random.default_rng(13)
    reqs = [(np.concatenate([prefix, rng.integers(1, tm.cfg.vocab_size, s)
                             .astype(np.int32)]), n)
            for s, n in ((3, 5), (7, 3), (5, 6))]
    want = [seq.generate(p[None], max_new_tokens=n, cache_len=MAX).tokens[0]
            for p, n in reqs]
    pool = PagedKVCachePool(tm, n_slots=2, max_len=MAX, page_size=PS)
    _, cache = tm.prefill(tp, {"tokens": prefix[None]},
                          tm.make_cache(1, pool.padded_len))
    index = PrefixIndex(PS)
    index.register(pool.bake_prefix(cache, prefix))
    eng = ContinuousBatchingEngine(tm, tp, pool=pool, prefix_index=index)
    ids = [eng.submit(p, n) for p, n in reqs]
    out = eng.run()
    for i, w in zip(ids, want):
        np.testing.assert_array_equal(out[i].tokens, w)
        assert out[i].reused_prefix_len == 13


@pytest.mark.parametrize("offset", [0, 8])
def test_streamed_prefill_equals_prefill_and_trace_equals_jax(offset):
    jm, jp, tm, tp = _pair()
    srv = TemplateServer(trace_batch=2, trace_seq=16)
    srv.register(tidal.static_function("moe", tm, tp), {})
    sess, _ = srv.fork("moe", {})
    toks = np.random.default_rng(2).integers(0, 256, (2, 16)).astype(np.int32)
    pre = tm.make_cache(2, 32)
    if offset:
        tm.prefill(tp, {"tokens": toks[:, :offset]}, pre)
    base = {k: v.clone() for k, v in pre.items()}
    lg_s, c_s = streamed_prefill(sess, {"tokens": toks[:, offset:]}, pre,
                                 offset=offset)
    lg_m, c_m = tm.prefill_from(tp, {"tokens": toks[:, offset:]}, base, offset)
    assert torch.equal(lg_s, lg_m)
    assert all(torch.equal(c_s[k], c_m[k]) for k in c_s)

    want = jax_trace(lambda p, i, c: jm.prefill(p, i, c),
                     jm.init_params(abstract=True),
                     jm.input_specs("prefill", 2, 16, dtype=jnp.float32),
                     jm.make_cache(2, 16, abstract=True)).order
    specs = tm.param_specs()
    tr = trace_weight_access(
        lambda p, t, c: transformer.prefill(p, tm.cfg, t, c), specs,
        torch.zeros((2, 16), dtype=torch.int32, device="meta"),
        transformer.make_cache(tm.cfg, 2, 16, device="meta"))
    assert [convert.jax_key(p) for p, _ in tr.order] == want
    assert srv.templates["moe"].order == tr.order
    assert not coverage(specs, tr)[1]


def test_serve_cli_moe_lora_on_the_cpu():
    """``--arch phi3.5-moe-42b-a6.6b --lora`` serves cold, fork and warm
    invocations (LoRA on ``blocks.attn.wq``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--layers", "2", "--functions", "2", "--requests",
         "6", "--lora", "--prompt-len", "16", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("req")]
    assert len(lines) == 6
    assert {ln.split()[3] for ln in lines} == {"cold", "fork", "warm"}, res.stdout


@pytest.mark.parametrize("family,extra", [
    ("zamba", {"use_mla": True, "attn_every": 2}),
    ("xlstm", {"slstm_every": 2, "use_mla": True}),
    ("encdec", {"is_encdec": True, "use_mla": True}),
    ("dense", {"n_experts": 8, "top_k": 2})])
def test_unported_families_raise_naming_what_is_left(family, extra):
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="x", family=family, n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                      **extra)
    with pytest.raises(NotImplementedError, match="MLA .*xLSTM .*enc-dec"):
        transformer.check_family(cfg)
