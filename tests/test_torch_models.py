"""The port's dense model, held against the JAX ``Model`` on the CPU.

JAX parameters (smoke configs, 2 layers, fp32) go through
``repro_torch.convert``; the same numpy tokens feed both packages.  The
JAX model runs with ``attn_impl="pallas"`` (the paged decode kernel in
interpret mode).  Tolerance: logits within atol 2e-4, as in
tests/test_kernels.py; greedy tokens identical.  TF32 is off.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import quant as jquant  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro.utils import tree_paths_and_leaves  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import quant as tquant  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ARCHS = ["smollm-135m", "qwen3-14b", "qwen2.5-32b", "gemma-2b", "llama3-8b",
         "llama2-13b", "chameleon-34b", "llama2-70b"]
ATOL = 2e-4
B, PS, NB = 2, 8, 4                     # decode batch, page size, blocks/seq


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


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=0)


def _scatter(dense, pt):
    """Dense [L, B, NB*PS, ...] cache -> paged arena [L, 1+B*NB, PS, ...]."""
    dense = np.asarray(dense)
    L = dense.shape[0]
    blk = dense.reshape((L, B, NB, PS) + dense.shape[3:])
    arena = np.zeros((L, 1 + B * NB, PS) + dense.shape[3:], dense.dtype)
    for b in range(B):
        for j in range(NB):
            arena[:, pt[b, j]] = blk[:, b, j]
    return arena


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_paged_decode_match_jax(arch, kv_dtype):
    """prefill, prefill_from, then 8 greedy decode_step_paged steps over a
    shuffled page arena (fp, or int8 quantized on append)."""
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(3)
    S, pre = 13, 8
    toks = rng.integers(0, jm.cfg.vocab_size, (B, S)).astype(np.int32)

    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.make_cache(B, NB * PS))
    tl, tc = tm.prefill(tp, {"tokens": toks}, tm.make_cache(B, NB * PS))
    _close(tl, jl)

    # suffix-only prefill over a cache holding the first `pre` tokens
    _, jc2 = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :pre])},
                        jm.make_cache(B, NB * PS))
    _, tc2 = tm.prefill(tp, {"tokens": toks[:, :pre]}, tm.make_cache(B, NB * PS))
    jl2, _ = jm.prefill_from(jp, {"tokens": jnp.asarray(toks[:, pre:])}, jc2, pre)
    tl2, _ = tm.prefill_from(tp, {"tokens": toks[:, pre:]}, tc2, pre)
    _close(tl2, jl2)
    _close(tl2, jl)

    pt = (rng.permutation(B * NB) + 1).reshape(B, NB).astype(np.int32)
    arena = {k: _scatter(jc[k], pt) for k in ("k", "v")}
    if kv_dtype == "int8":
        for k in ("k", "v"):
            q, s = jquant.quantize_rows(jnp.asarray(arena[k]))
            arena[k], arena[k + "_scale"] = np.asarray(q), np.asarray(s)
    ja = {k: jnp.asarray(v) for k, v in arena.items()}
    ta = {k: torch.from_numpy(v.copy()) for k, v in arena.items()}
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_step_paged(
        p, c, {"tokens": t}, pos, jnp.asarray(pt), PS))
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    for _ in range(8):
        jl, ja = jdec(jp, ja, jnp.asarray(tok), jnp.asarray(pos))
        tl, ta = tm.decode_step_paged(tp, ta, {"tokens": tok}, pos, pt, PS)
        _close(tl, jl)
        jt = np.argmax(np.asarray(jl), axis=-1)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jt)
        tok, pos = jt.astype(np.int32)[:, None], pos + 1
    if kv_dtype == "int8":
        # rows appended by the decode steps quantize to the same scales
        np.testing.assert_allclose(ta["k_scale"].numpy(),
                                   np.asarray(ja["k_scale"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma-2b"])
def test_forward_and_dense_decode_match_jax(arch):
    """The no-cache branch (flash) and the dense-cache decode branch with
    per-sequence positions."""
    jm, jp, tm, tp = _pair(arch)
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (B, 11)).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, training=False)
    tl, _ = tm.forward(tp, {"tokens": toks})
    _close(tl, jl)
    jc = jm.make_cache(B, 16)
    tc = tm.make_cache(B, 16)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = tm.prefill(tp, {"tokens": toks}, tc)
    pos = np.full((B,), 11, np.int32)
    for _ in range(3):
        t = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(t)}, pos)
        tl, tc = tm.decode_step(tp, tc, {"tokens": t}, pos)
        _close(tl, jl)
        pos = pos + 1


def test_quantize_rows_matches_jax_and_roundtrips():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32) * 3
    x[0, 0] = 0.0                                     # an all-zero row
    jq, js = jquant.quantize_rows(jnp.asarray(x))
    tq, ts = tquant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tquant.dequantize_rows(tq, ts, torch.float32)
    tq2, ts2 = tquant.quantize_rows(back)
    assert torch.equal(tq2, tq) and torch.equal(ts2, ts)


def test_convert_unstacks_layers_and_names_every_leaf():
    jm, jp, tm, tp = _pair("qwen3-14b")
    L = jm.cfg.n_layers
    jax_leaves = dict(tree_paths_and_leaves(jp))
    port = dict(convert.named_parameters(tp))
    table = {p: convert.port_names(p, L) for p in jax_leaves}
    assert table["blocks.attn.wq"] == [f"layers.{i}.attn.wq" for i in range(L)]
    assert table["embed"] == ["embed"]
    assert sorted(n for names in table.values() for n in names) == sorted(port)
    for path, names in table.items():
        leaf = np.asarray(jax_leaves[path])
        for i, name in enumerate(names):
            want = leaf[i] if len(names) > 1 else leaf
            np.testing.assert_array_equal(port[name].numpy(), want)


def test_init_params_is_seeded_and_fan_in_scaled():
    tm = torch_smoke("smollm-135m", device="cpu", n_layers=2)
    a, b = tm.init_params(seed=3), tm.init_params(seed=3)
    for (n, x), (_, y) in zip(convert.named_parameters(a),
                              convert.named_parameters(b)):
        assert torch.equal(x, y), n
    wq = a["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - tm.cfg.d_model ** -0.5) < 0.02
    assert "lm_head" not in a                          # tied embeddings


@pytest.mark.parametrize("arch", ["llama2-13b", "chameleon-34b", "llama2-70b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_configs_and_smoke_configs_match_jax(arch):
    """The port's own copy of each config, full and reduced, agrees with
    the JAX package's on every field the port keeps."""
    from repro.models.registry import get_config as jax_config
    from repro_torch.models.config import reduced
    from repro_torch.models.registry import get_config
    for full in (False, True):
        tc, jc = get_config(arch), jax_config(arch)
        if not full:
            tc, jc = reduced(tc), jax_smoke(arch).cfg
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), (full, f.name)


_ONES = {"attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm", "norm",
         "d_skip"}
_ZEROS = {"bq", "bk", "bv", "dt_bias", "a_log"}


def _one_draw(cfg, seed):
    """The whole float32 tree from one seeded CPU generator in creation
    order, then cast to the model dtype: the weights ``init_params`` gave
    before it drew leaf by leaf."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for name, spec in convert.named_parameters(transformer.param_specs(cfg)):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _ONES:
            t = torch.ones(spec.shape)
        elif leaf in _ZEROS:
            t = torch.zeros(spec.shape)
        else:
            scale = {"embed": 0.02, "lm_head": 0.02, "conv_w": 0.5,
                     "router": cfg.d_model ** -0.5}.get(leaf,
                                                        spec.shape[0] ** -0.5)
            t = torch.randn(tuple(spec.shape), generator=gen) * scale
        out.append((name, t.to(spec.dtype)))
    return out


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-32b",
                                  "phi3.5-moe-42b-a6.6b", "zamba2-2.7b"])
def test_init_params_leaf_by_leaf_equals_one_draw(arch):
    """Drawing, casting and moving each leaf as it is drawn gives the same
    bf16 weights, bit for bit, as drawing the whole tree first."""
    tm = torch_smoke(arch, device="cpu", n_layers=2, dtype="bfloat16")
    got = list(convert.named_parameters(tm.init_params(seed=5)))
    want = _one_draw(tm.cfg, 5)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), name


def test_paged_decode_equals_dense_decode_in_port():
    """Inside the port, the paged arena reproduces the dense cache."""
    _, _, tm, tp = _pair("qwen3-14b")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tm.cfg.vocab_size, (B, 10)).astype(np.int32)
    dense = tm.make_cache(B, NB * PS)
    logits, dense = tm.prefill(tp, {"tokens": toks}, dense)
    pt = (rng.permutation(B * NB) + 1).reshape(B, NB).astype(np.int32)
    arena = {k: torch.from_numpy(_scatter(dense[k].numpy(), pt)) for k in dense}
    pos = np.full((B,), 10, np.int32)
    for _ in range(4):
        tok = logits.argmax(-1).to(torch.int32)[:, None].numpy()
        logits, dense = tm.decode_step(tp, dense, {"tokens": tok}, pos)
        lp, arena = tm.decode_step_paged(tp, arena, {"tokens": tok}, pos, pt, PS)
        torch.testing.assert_close(lp, logits, atol=1e-5, rtol=1e-5)
        pos = pos + 1
