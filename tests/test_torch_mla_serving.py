"""deepseek-v3 (MLA, latent caches) through the port's serving stack,
held against the JAX package on the CPU.

Counterparts of tests/test_runtime.py's dense-pool scatter / gather
(:44), paged write / read round trip (:168), continuous == sequential
(:210) and paged engine == sequential ``Engine`` (:224); chunked prefill
(tests/test_chunked_prefill.py:29); prefix reuse with a copy-on-write
partial page (tests/test_prefix_reuse.py:259); the int8 latent arena
(tests/test_quantized_kv.py:88); streamed prefill with and without an
offset (tests/test_streaming.py:44); the traced access order
(tests/test_tracing.py:11); ``FaaSRuntime`` cold / warm / fork; the serve
CLI.  Greedy tokens are compared exactly (with the port's ``Engine`` and
the JAX engines); smoke configs at 2 layers, fp32, TF32 off.
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
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro.runtime.continuous import ContinuousBatchingEngine as JaxCBE  # noqa: E402
from repro.utils import tree_bytes as jax_tree_bytes  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tidal  # noqa: E402
from repro_torch.core.streaming import streamed_prefill  # noqa: E402
from repro_torch.core.template_server import TemplateServer  # noqa: E402
from repro_torch.core.tracing import (coverage, trace_weight_access,  # noqa: E402
                                      weight_sizes)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402
from repro_torch.runtime import (ContinuousBatchingEngine, Engine,  # noqa: E402
                                 FaaSRuntime, KVCachePool, PagedKVCachePool,
                                 PrefixIndex)
from repro_torch.runtime.gateway import InvocationRequest  # noqa: E402
from repro_torch.utils import tree_bytes  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
ARCH = "deepseek-v3-671b"
ROOT = Path(__file__).resolve().parent.parent
MAX_LEN = 32
_PAIRS: dict = {}


def _pair():
    """JAX and port smoke deepseek-v3 (2 layers) with the same weights."""
    if not _PAIRS:
        jm = jax_smoke(ARCH, n_layers=2)
        tm = torch_smoke(ARCH, device="cpu", n_layers=2)
        jp = jm.init_params(jax.random.PRNGKey(2))
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                     device="cpu")
        _PAIRS["p"] = (jm, jp, tm, tp)
    return _PAIRS["p"]


def _requests(vocab, seed, spec=((4, 5), (9, 3), (6, 7), (11, 4), (5, 6))):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, n).astype(np.int32), mn) for n, mn in spec]


def _serve(engine, reqs):
    ids = [engine.submit(p, mn) for p, mn in reqs]
    out = engine.run()
    return [out[i].tokens for i in ids]


def _sequential(tm, tp, reqs):
    eng = Engine(tm, tp)
    return [eng.generate(p[None], max_new_tokens=n, cache_len=MAX_LEN).tokens[0]
            for p, n in reqs]


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

def test_dense_pool_scatter_gather_roundtrip():
    _, _, tm, _ = _pair()
    pool = KVCachePool(tm, n_slots=3, max_len=8)
    assert set(pool.cache) == {"c_kv", "k_rope"}
    subs = []
    for slot in range(3):
        sub = {k: torch.full_like(v, slot + 1.0)
               for k, v in tm.make_cache(1, 8).items()}
        subs.append(sub)
        pool.write_slot(slot, sub)
    for slot in (2, 0, 1):
        got = pool.read_slot(slot)
        for k in got:
            assert torch.equal(got[k], subs[slot][k])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_pool_write_read_roundtrip_and_bytes(kv_dtype):
    """write_prompt -> read_slot reproduces the dense latent sub-cache
    (int8: within one quantization step per row); a page's bytes count
    the latent and rope-key rows (and their scales in int8)."""
    _, _, tm, _ = _pair()
    cfg = tm.cfg
    pool = PagedKVCachePool(tm, n_slots=2, max_len=16, page_size=4,
                            kv_dtype=kv_dtype)
    n_tok = 10
    sub = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(0))
           for k, v in tm.make_cache(1, pool.padded_len).items()}
    slot = pool.alloc(n_tok, 4)
    pool.write_prompt(slot, sub, n_tok)
    got = pool.read_slot(slot, n_tok)
    nb = pool.blocks_for(n_tok) * pool.page_size
    for k in sub:
        want = sub[k][:, :, :nb]
        if kv_dtype is None:
            assert torch.equal(got[k], want)
        else:
            step = want.abs().amax(-1, keepdim=True) / 127
            assert bool(((got[k] - want).abs() <= step / 2 + 1e-7).all())
    row = cfg.kv_lora_rank + cfg.qk_rope_dim
    per_token = row * 4 if kv_dtype is None else row + 2 * 4
    assert pool.page_nbytes() == cfg.n_layers * pool.page_size * per_token
    assert pool.resident_nbytes() == pool.n_used_pages * pool.page_nbytes()
    if kv_dtype == "int8":
        assert set(pool.cache) == {"c_kv", "c_kv_scale", "k_rope",
                                   "k_rope_scale"}
        assert pool.cache["c_kv_scale"].shape == pool.cache["c_kv"].shape[:-1]


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged,kv_dtype", [(True, None), (False, None),
                                            (True, "int8")],
                         ids=["paged", "dense-pool", "paged-int8"])
def test_engine_tokens_match_sequential_and_jax(paged, kv_dtype):
    """Greedy tokens of the port's continuous engine (2 slots, mid-decode
    admissions) equal the port's sequential ``Engine`` and the JAX
    continuous engine's for the same run (int8: the JAX int8 engine's)."""
    jm, jp, tm, tp = _pair()
    reqs = _requests(tm.cfg.vocab_size, 13)
    jwant = _serve(JaxCBE(jm, jp, n_slots=2, max_len=MAX_LEN, page_size=8,
                          paged=paged, kv_dtype=kv_dtype, donate_cache=False),
                   reqs)
    eng = ContinuousBatchingEngine(tm, tp, n_slots=2, max_len=MAX_LEN,
                                   page_size=8, paged=paged, kv_dtype=kv_dtype)
    assert eng.paged == paged
    assert isinstance(eng.pool, PagedKVCachePool if paged else KVCachePool)
    got = _serve(eng, reqs)
    for g, w in zip(got, jwant):
        np.testing.assert_array_equal(g, w)
    if kv_dtype is None:
        for g, w in zip(got, _sequential(tm, tp, reqs)):
            np.testing.assert_array_equal(g, w)


def test_chunked_prefill_and_prefix_reuse_match_whole_prefill():
    """Chunked prefill (page and non-page chunk sizes) and a baked prefix
    with a copy-on-write partial page give the whole prefill's tokens
    (the sequential ``Engine``), and the JAX chunked engine's; a prefix
    hit maps fewer fresh pages."""
    jm, jp, tm, tp = _pair()
    PS = 4
    reqs = _requests(tm.cfg.vocab_size, 0, ((21, 5), (4, 6), (17, 3), (9, 4)))
    want = _sequential(tm, tp, reqs)
    for chunk in (None, PS, 7):
        got = _serve(ContinuousBatchingEngine(tm, tp, n_slots=3, max_len=MAX_LEN,
                                              page_size=PS, chunk_tokens=chunk),
                     reqs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    jgot = _serve(JaxCBE(jm, jp, n_slots=3, max_len=MAX_LEN, page_size=PS,
                         chunk_tokens=PS, donate_cache=False), reqs)
    for g, w in zip(jgot, want):
        np.testing.assert_array_equal(g, w)

    prefix = np.random.default_rng(1).integers(1, tm.cfg.vocab_size, 13
                                               ).astype(np.int32)
    rng = np.random.default_rng(13)
    reqs = [(np.concatenate([prefix, rng.integers(1, tm.cfg.vocab_size, s)
                             .astype(np.int32)]), n)
            for s, n in ((3, 5), (7, 3), (5, 6))]
    want = _sequential(tm, tp, reqs)
    pool = PagedKVCachePool(tm, n_slots=2, max_len=MAX_LEN, page_size=PS)
    _, cache = tm.prefill(tp, {"tokens": prefix[None]},
                          tm.make_cache(1, pool.padded_len))
    index = PrefixIndex(PS)
    index.register(pool.bake_prefix(cache, prefix))
    fresh0 = pool.stats["fresh_pages_mapped"]
    eng = ContinuousBatchingEngine(tm, tp, pool=pool, prefix_index=index)
    ids = [eng.submit(p, n) for p, n in reqs]
    out = eng.run()
    for i, w in zip(ids, want):
        np.testing.assert_array_equal(out[i].tokens, w)
        assert out[i].reused_prefix_len == 13
    with_prefix = pool.stats["fresh_pages_mapped"] - fresh0
    assert pool.stats["cow_page_copies"] == len(reqs)
    flat = ContinuousBatchingEngine(tm, tp, n_slots=2, max_len=MAX_LEN,
                                    page_size=PS)
    for g, w in zip(_serve(flat, reqs), want):
        np.testing.assert_array_equal(g, w)
    assert with_prefix < flat.pool.stats["fresh_pages_mapped"]


# ---------------------------------------------------------------------------
# TIDAL: streamed prefill, tracing, FaaS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 8])
def test_streamed_prefill_equals_prefill(offset):
    """The layer-streamed prefill of a fork equals ``prefill_from`` and,
    at offset 0, the monolithic prefill, bit for bit (latent caches too)."""
    _, _, tm, tp = _pair()
    srv = TemplateServer(trace_batch=1, trace_seq=16)
    srv.register(tidal.static_function("f", tm, tp), {})
    sess, _ = srv.fork("f", {})
    toks = np.random.default_rng(2).integers(0, 256, (1, 16)).astype(np.int32)
    pre = tm.make_cache(1, 16)
    if offset:
        tm.prefill(tp, {"tokens": toks[:, :offset]}, pre)
    base = {k: v.clone() for k, v in pre.items()}
    lg_s, c_s = streamed_prefill(sess, {"tokens": toks[:, offset:]}, pre,
                                 offset=offset)
    lg_f, c_f = tm.prefill_from(tp, {"tokens": toks[:, offset:]}, base, offset)
    assert torch.equal(lg_s, lg_f)
    assert all(torch.equal(c_s[k], c_f[k]) for k in c_s)
    if not offset:
        lg_m, c_m = tm.prefill(tp, {"tokens": toks}, tm.make_cache(1, 16))
        assert torch.equal(lg_s, lg_m)
        assert all(torch.equal(c_s[k], c_m[k]) for k in c_s)


def test_traced_order_equals_jax():
    """The traced access order of the smoke deepseek-v3 (4 layers) equals
    the JAX tracer's key for key, covers every parameter, and its bytes
    equal the parameters'."""
    jm = jax_smoke(ARCH)
    tm = torch_smoke(ARCH, device="cpu")
    jspecs = jm.init_params(abstract=True)
    want = jax_trace(lambda p, i, c: jm.prefill(p, i, c), jspecs,
                     jm.input_specs("prefill", 2, 16, dtype=jnp.float32),
                     jm.make_cache(2, 16, abstract=True)).order
    specs = tm.param_specs()
    tr = trace_weight_access(
        lambda p, t, c: transformer.prefill(p, tm.cfg, t, c), specs,
        torch.zeros((2, 16), dtype=torch.int32, device="meta"),
        transformer.make_cache(tm.cfg, 2, 16, device="meta"))
    assert [convert.jax_key(p) for p, _ in tr.order] == want
    assert not coverage(specs, tr)[1]
    assert len(set(tr.order)) == len(tr.order)
    assert sum(weight_sizes(specs, tr.order).values()) == tree_bytes(specs) \
        == jax_tree_bytes(jspecs)
    assert ("rmsnorm", ((( 2, 16, 16), "float32"), ((16,), "float32"))) in {
        (n, s[:2]) for n, s in tr.kernels}


def test_faas_cold_warm_fork_with_a_template_prompt():
    """``FaaSRuntime`` serves a static deepseek-v3 function cold, warm,
    then forked after an evict (streamed prefill, the template prompt's
    latent KV reused): fork tokens equal warm tokens and the sequential
    ``Engine``'s."""
    _, _, tm, tp = _pair()
    rt = FaaSRuntime(n_slots=2, max_len=48, page_size=4, device="cpu",
                     trace_seq=16)
    prefix = np.random.default_rng(4).integers(1, 256, 13).astype(np.int32)
    rt.deploy(tidal.static_function("ds", tm, tp), {}, prewarm_seq=16,
              template_prompt=prefix)
    prompt = np.concatenate([prefix, np.arange(5, 14, dtype=np.int32)])

    def run():
        return rt.submit(InvocationRequest("ds", prompt,
                                           max_new_tokens=6)).result()

    cold, warm = run(), run()
    rt.evict()
    fork, warm2 = run(), run()
    assert [r.kind for r in (cold, warm, fork, warm2)] == [
        "cold", "warm", "fork", "warm"]
    assert fork.streamed_prefill
    assert all(r.reused_prefix_len >= 8 for r in (cold, warm, fork, warm2))
    want = Engine(tm, tp).generate(prompt[None], max_new_tokens=6,
                                   cache_len=48).tokens[0]
    for r in (cold, warm, fork, warm2):
        np.testing.assert_array_equal(r.tokens, want)
    assert fork.fork_stats.streamed_bytes == tree_bytes(tp)


def test_serve_cli_deepseek_on_the_cpu():
    """``--arch deepseek-v3-671b --device cpu --layers 2`` serves cold and
    warm invocations; ``--lora`` exits naming the missing GQA projection."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
            "cpu", "--arch", ARCH, "--layers", "2", "--functions", "2",
            "--requests", "5", "--prompt-len", "16", "--max-new", "4"]
    res = subprocess.run(base, capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("req")]
    assert len(lines) == 5
    assert {ln.split()[2] for ln in lines} == {"cold", "warm"}, res.stdout
    res = subprocess.run(base + ["--lora"], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode != 0
    assert "MLA" in res.stderr and "blocks.attn.wq" in res.stderr, res.stderr
