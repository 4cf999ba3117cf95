"""The port's MLA (deepseek-v3), held against the JAX package on the CPU.

``repro_torch.models.mla.mla_attention_block`` against
``repro.models.mla.mla_attention_block`` in all five cache modes (none,
dense at one position, dense per sequence, paged fp, paged int8): outputs
and updated caches; the smoke deepseek-v3's prefill, ``prefill_from``,
dense decode and paged decode (fp and int8) logits against the JAX
``Model``; the shared expert through ``moe_block``; the config and its
reduced (smoke) form; the sequence-at-a-time decode products.  Weights
carried by ``convert.params_from_jax``; smoke configs, fp32, TF32 off.
Tolerance: 1e-5 of the largest |value| compared.  The serving paths are
in tests/test_torch_mla_serving.py.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import quant as jquant  # noqa: E402
from repro.models.config import reduced as jax_reduced  # noqa: E402
from repro.models.registry import get_config as jax_config  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import mla, moe, transformer  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
ARCH = "deepseek-v3-671b"
RTOL = 1e-5
_PAIRS: dict = {}


def _pair(n_layers=2):
    """JAX and port smoke deepseek-v3 models with the same weights."""
    if n_layers not in _PAIRS:
        jm = jax_smoke(ARCH, n_layers=n_layers)
        tm = torch_smoke(ARCH, device="cpu", n_layers=n_layers)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                     device="cpu")
        _PAIRS[n_layers] = (jm, jp, tm, tp)
    return _PAIRS[n_layers]


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    tol = RTOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_config_and_smoke_config_match_jax():
    """The port's deepseek-v3 config and its reduced form carry the JAX
    package's values in every field the two configs share."""
    for mk_j, mk_t in ((lambda c: c, lambda c: c),
                       (jax_reduced, reduced)):
        jc, tc = mk_j(jax_config(ARCH)), mk_t(get_config(ARCH))
        shared = {f.name for f in dataclasses.fields(tc)}
        for name in shared:
            assert getattr(tc, name) == getattr(jc, name), name
    tc = reduced(get_config(ARCH))
    assert (tc.n_layers, tc.d_model, tc.q_lora_rank, tc.kv_lora_rank,
            tc.qk_nope_dim, tc.qk_rope_dim, tc.v_head_dim, tc.n_experts,
            tc.top_k, tc.n_shared_experts) == (4, 64, 32, 16, 16, 8, 16, 8, 2, 1)
    assert tc.capacity_factor == tc.n_experts / tc.top_k
    transformer.check_family(get_config(ARCH))


# ---------------------------------------------------------------------------
# the attention block, five cache modes
# ---------------------------------------------------------------------------

def _block_case(mode, cfg, rng):
    """Inputs of one MLA call: (x, positions, cache (numpy leaves or
    None), cache_pos, page_table, page_size)."""
    kvr, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    B, PS, NB = 2, 4, 6
    if mode == "none":
        S = 9
        return (rng.standard_normal((B, S, cfg.d_model)),
                np.tile(np.arange(S), (B, 1)), None, None, None, 0)
    if mode == "dense_scalar":
        T, pos, S = 24, 5, 7
        cache = {"c_kv": rng.standard_normal((B, T, kvr)),
                 "k_rope": rng.standard_normal((B, T, dr))}
        return (rng.standard_normal((B, S, cfg.d_model)),
                np.tile(pos + np.arange(S), (B, 1)), cache, pos, None, 0)
    pos = np.array([3, 17], np.int32)
    x = rng.standard_normal((B, 1, cfg.d_model))
    if mode == "dense_per_seq":
        T = 24
        cache = {"c_kv": rng.standard_normal((B, T, kvr)),
                 "k_rope": rng.standard_normal((B, T, dr))}
        return x, pos[:, None], cache, pos, None, 0
    P = 1 + B * NB
    pt = (rng.permutation(B * NB) + 1).reshape(B, NB).astype(np.int32)
    cache = {"c_kv": rng.standard_normal((P, PS, kvr)),
             "k_rope": rng.standard_normal((P, PS, dr))}
    if mode == "paged_int8":
        for k in ("c_kv", "k_rope"):
            q, s = jquant.quantize_rows(jnp.asarray(cache[k], jnp.float32))
            cache[k], cache[k + "_scale"] = np.asarray(q), np.asarray(s)
    return x, pos[:, None], cache, pos, pt, PS


@pytest.mark.parametrize("mode", ["none", "dense_scalar", "dense_per_seq",
                                  "paged_fp", "paged_int8"])
def test_mla_block_matches_jax(mode):
    """Output and updated cache of one MLA call equal the reference's
    within 1e-5 of their largest |value| (int8 leaves exactly)."""
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    x, positions, cache, cache_pos, pt, ps = _block_case(mode, cfg, rng)
    f32 = lambda a: a.astype(np.float32) if a.dtype == np.float64 else a  # noqa: E731
    x, positions = f32(x), positions.astype(np.int32)
    cache = None if cache is None else {k: f32(v) for k, v in cache.items()}
    jblk = jax.tree.map(lambda a: a[1], jp["blocks"]["attn"])
    want, want_cache = jmla.mla_attention_block(
        jblk, jnp.asarray(x), jm.cfg, jnp.asarray(positions),
        None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()},
        cache_pos if isinstance(cache_pos, int) or cache_pos is None
        else jnp.asarray(cache_pos),
        page_table=None if pt is None else jnp.asarray(pt), page_size=ps)
    tcache = (None if cache is None
              else {k: torch.from_numpy(v.copy()) for k, v in cache.items()})
    got, got_cache = mla.mla_attention_block(
        tp["layers"][1]["attn"], torch.from_numpy(x), cfg,
        torch.from_numpy(positions), tcache,
        cache_pos if isinstance(cache_pos, int) or cache_pos is None
        else torch.from_numpy(cache_pos),
        page_table=None if pt is None else torch.from_numpy(pt), page_size=ps)
    _close(got, want)
    if cache is None:
        assert want_cache is None
        return
    assert set(got_cache) == set(want_cache) == set(cache)
    for k in cache:
        if got_cache[k].dtype == torch.int8:
            np.testing.assert_array_equal(got_cache[k].numpy(),
                                          np.asarray(want_cache[k]))
        else:
            _close(got_cache[k], want_cache[k])


def test_decode_runs_the_products_one_sequence_at_a_time():
    """A decode call's rows equal the same sequences decoded alone (within
    1e-5 here; bit for bit on the card, where the products are what
    varied with the batch: chip_smoke.py phase 11), and each per-sequence
    product equals the batched einsum."""
    _, _, tm, tp = _pair()
    cfg = tm.cfg
    rng = np.random.default_rng(6)
    x, positions, cache, cache_pos, _, _ = _block_case("dense_per_seq", cfg, rng)
    x = torch.from_numpy(x.astype(np.float32))
    cache = {k: torch.from_numpy(v.astype(np.float32)) for k, v in cache.items()}
    pos = torch.from_numpy(cache_pos)
    blk = tp["layers"][0]["attn"]
    both, _ = mla.mla_attention_block(blk, x, cfg, pos[:, None],
                                      {k: v.clone() for k, v in cache.items()}, pos)
    for b in range(2):
        one, _ = mla.mla_attention_block(
            blk, x[b:b + 1], cfg, pos[b:b + 1, None],
            {k: v[b:b + 1].clone() for k, v in cache.items()}, pos[b:b + 1])
        _close(one[0], both[b])
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(3, 1, 4, 16, generator=g), torch.randn(3, 20, 4, 16, generator=g)
    kr, pr = torch.randn(3, 20, 16, generator=g), torch.randn(3, 1, 4, 20, generator=g)
    for eq, a, b in (("bshd,bthd->bsht", q, k), ("bshd,btd->bsht", q, kr),
                     ("bsht,bthd->bshd", pr, k)):
        got = mla._per_sequence(eq, a, b)
        _close(got, torch.einsum(eq, a, b))
        for i in range(3):
            assert torch.equal(got[i:i + 1], torch.einsum(eq, a[i:i + 1], b[i:i + 1]))


# ---------------------------------------------------------------------------
# the shared expert
# ---------------------------------------------------------------------------

def test_shared_expert_matches_jax():
    """``moe_block`` with deepseek's shared expert equals the reference's,
    and the shared branch is a real part of the output."""
    jm, jp, tm, tp = _pair()
    x = np.random.default_rng(7).standard_normal(
        (2, 16, tm.cfg.d_model)).astype(np.float32)
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    tblk = tp["layers"][0]["moe"]
    assert set(tblk["shared"]) == {"w_gate", "w_up", "w_down"}
    assert tblk["shared"]["w_gate"].shape == (tm.cfg.d_model, tm.cfg.moe_d_ff)
    want = jmoe.moe_block(jblk, jnp.asarray(x), jm.cfg)
    got = moe.moe_block(tblk, torch.from_numpy(x), tm.cfg)
    _close(got, want)
    routed = moe.moe_block({k: v for k, v in tblk.items() if k != "shared"},
                           torch.from_numpy(x), tm.cfg)
    assert float((got - routed).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefill_and_decode_logits_match_jax(kv_dtype):
    """prefill, prefill_from, 3 dense decode steps, then 5 greedy paged
    decode steps over a shuffled latent arena (fp, or int8 quantized on
    append): logits within 1e-5 of the largest, tokens equal."""
    jm, jp, tm, tp = _pair()
    B, PS, NB, S, pre = 2, 4, 6, 11, 6
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.make_cache(B, NB * PS))
    tl, tc = tm.prefill(tp, {"tokens": toks}, tm.make_cache(B, NB * PS))
    _close(tl, jl)
    assert set(tc) == {"c_kv", "k_rope"}
    for k in tc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape)
        _close(tc[k], jc[k])
    _, tc2 = tm.prefill(tp, {"tokens": toks[:, :pre]}, tm.make_cache(B, NB * PS))
    _, jc2 = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :pre])},
                        jm.make_cache(B, NB * PS))
    jl2, _ = jm.prefill_from(jp, {"tokens": jnp.asarray(toks[:, pre:])}, jc2, pre)
    tl2, _ = tm.prefill_from(tp, {"tokens": toks[:, pre:]}, tc2, pre)
    _close(tl2, jl2)

    # dense decode (per-sequence positions)
    jd = {k: jnp.asarray(v) for k, v in jc.items()}
    td = {k: v.clone() for k, v in tc.items()}
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    for _ in range(3):
        jdl, jd = jm.decode_step(jp, jd, {"tokens": jnp.asarray(tok)},
                                 jnp.asarray(pos))
        tdl, td = tm.decode_step(tp, td, {"tokens": tok}, pos)
        _close(tdl, jdl)
        tok, pos = np.argmax(np.asarray(jdl), -1).astype(np.int32)[:, None], pos + 1

    # paged decode from the prefill's cache
    pt = (rng.permutation(B * NB) + 1).reshape(B, NB).astype(np.int32)
    arena = {}
    for k in ("c_kv", "k_rope"):
        dense = np.asarray(jc[k]).reshape((jm.cfg.n_layers, B, NB, PS, -1))
        a = np.zeros((jm.cfg.n_layers, 1 + B * NB, PS, dense.shape[-1]),
                     np.float32)
        for b in range(B):
            for j in range(NB):
                a[:, pt[b, j]] = dense[:, b, j]
        arena[k] = a
    if kv_dtype == "int8":
        for k in ("c_kv", "k_rope"):
            q, s = jquant.quantize_rows(jnp.asarray(arena[k]))
            arena[k], arena[k + "_scale"] = np.asarray(q), np.asarray(s)
    ja = {k: jnp.asarray(v) for k, v in arena.items()}
    ta = {k: torch.from_numpy(v.copy()) for k, v in arena.items()}
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    for _ in range(5):
        jl, ja = jm.decode_step_paged(jp, ja, {"tokens": jnp.asarray(tok)},
                                      jnp.asarray(pos), jnp.asarray(pt), PS)
        tl, ta = tm.decode_step_paged(tp, ta, {"tokens": tok}, pos, pt, PS)
        _close(tl, jl)
        jt = np.argmax(np.asarray(jl), -1)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jt)
        tok, pos = jt.astype(np.int32)[:, None], pos + 1
    for k in ta:
        if ta[k].dtype == torch.int8:
            np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]))
        else:
            _close(ta[k], ja[k])


def test_param_tree_matches_jax():
    """Every JAX leaf maps to a port leaf of the same shape (MLA's
    projections and norms, the routed and shared experts), and back."""
    jm, jp, tm, tp = _pair()
    specs = dict(convert.named_parameters(tm.param_specs()))
    port = {}
    for name, t in specs.items():
        path, idx = convert.jax_key(name)
        port.setdefault(path, []).append((idx, tuple(t.shape)))
    want = {}
    for path, leaf in convert._flatten(jax.tree.map(np.asarray, jp)):
        want[path] = leaf.shape
    assert set(port) == set(want)
    for path, entries in port.items():
        if entries[0][0]:
            assert sorted(i for (i,), _ in entries) == list(range(tm.cfg.n_layers))
            assert all(s == want[path][1:] for _, s in entries), path
        else:
            assert entries[0][1] == want[path], path
    assert {"wq_a", "q_a_norm", "wq_b", "wkv_a", "kv_a_norm", "wkv_b", "wo"} == set(
        tp["layers"][0]["attn"])


def test_paged_int8_arena_leaves():
    """The int8 latent arena holds exactly the value leaves and one fp32
    scale per cached row."""
    _, _, tm, _ = _pair()
    arena = tm.make_paged_cache(5, 4, kv_dtype="int8")
    assert set(arena) == {"c_kv", "c_kv_scale", "k_rope", "k_rope_scale"}
    L, kvr, dr = tm.cfg.n_layers, tm.cfg.kv_lora_rank, tm.cfg.qk_rope_dim
    assert arena["c_kv"].shape == (L, 5, 4, kvr) and arena["c_kv"].dtype == torch.int8
    assert arena["k_rope"].shape == (L, 5, 4, dr)
    for k in ("c_kv", "k_rope"):
        assert arena[k + "_scale"].shape == arena[k].shape[:-1]
        assert arena[k + "_scale"].dtype == torch.float32


def test_adapter_bank_and_gather_refuse_mla():
    """The adapter bank targets GQA projections; MLA has none, so the bank
    refuses the config (as ``repro.models.adapters`` does) and a block
    given adapter slices raises."""
    from repro_torch.models import adapters
    _, _, tm, tp = _pair()
    with pytest.raises(ValueError, match="GQA"):
        adapters.check_bank_config(tm, ["blocks.attn.wq"], 2)
    x = torch.zeros(1, 2, tm.cfg.d_model)
    pos = torch.arange(2)[None]
    with pytest.raises(NotImplementedError, match="not MLA"):
        transformer._dense_block(tp["layers"][0], x, tm.cfg, pos, None, None,
                                 adapters={}, adapter_ids=torch.zeros(1))
