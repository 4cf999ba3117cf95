"""The port's enc-dec (whisper) model, held against the JAX package on the
CPU.

* ``layernorm`` within 1e-6; ``sinusoids`` and ``make_frames`` equal;
* the smoke whisper (2 + 2 layers, d 64, 4 heads of 16, fp32; weights
  from ``convert.params_from_jax``): ``encode`` within 1e-5 of the largest
  |state|; ``forward``, and ``prefill`` then ``decode_step``, logits
  within 1e-4 of the largest |logit| and the same greedy tokens; the
  port's prefill then decode against its own ``forward`` (as
  tests/test_models.py does for the JAX package);
* ``Engine.generate(frames=)`` at B = 2 over 37 frames: greedy tokens
  equal to the JAX ``Engine``'s over 10 steps;
* the refusals: ``ContinuousBatchingEngine``, ``make_paged_cache``,
  ``prefill_from``, a ``[B]`` position, decoder positions past
  ``max_dec_len``; a whisper function deploys in ``FaaSRuntime`` and its
  invocation raises the JAX runtime's error type; the serve CLI exits;
* ``convert``: every whisper leaf round-trips; ``TemplateServer.register``
  of a whisper function traces the reference's access order;
* the kernel launches of one whisper-medium prefill and decode step,
  counted on ``meta`` tensors: 72 flash (24 of them causal) and 48
  ``decode_attention``, nothing else.

Inputs are drawn with numpy from fixed seeds.  TF32 is off.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import api as jax_api  # noqa: E402
from repro.core.template_server import TemplateServer as JaxServer  # noqa: E402
from repro.data.pipeline import make_frames as jax_frames  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.layers import layernorm as jax_layernorm  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro.runtime.engine import Engine as JaxEngine  # noqa: E402
from repro.runtime.faas import FaaSRuntime as JaxRuntime  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tidal  # noqa: E402
from repro_torch.core.streaming import supports_streamed_prefill  # noqa: E402
from repro_torch.core.template_server import TemplateServer  # noqa: E402
from repro_torch.data.pipeline import make_frames, make_prompts  # noqa: E402
from repro_torch.kernels import meta  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.layers import layernorm  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402
from repro_torch.runtime import ContinuousBatchingEngine, Engine, FaaSRuntime  # noqa: E402
from repro_torch.utils import named_leaves  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ARCH = "whisper-medium"
LOGIT_RTOL = 1e-4               # of the largest |logit|
ENC_RTOL = 1e-5                 # of the largest |encoder state|


def _close_rel(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _greedy(logits) -> np.ndarray:
    return np.asarray(logits).argmax(-1).astype(np.int32)


def _perturbed(jp: dict, seed: int) -> dict:
    """The JAX parameters with the zero biases and unit norm scales moved
    off 0 and 1, so every bias and scale enters the comparison."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k.startswith("b") or k in ("scale", "bias"):
                base = 1.0 if k == "scale" else 0.0
                noise = 0.1 * rng.standard_normal(np.shape(v))
                out[k] = jnp.asarray((base + noise).astype(np.float32))
            else:
                out[k] = v
        return out
    return walk(jp)


@pytest.fixture(scope="module")
def whisper():
    jm = jax_smoke(ARCH)
    tm = torch_smoke(ARCH, device="cpu")
    jp = _perturbed(jm.init_params(jax.random.PRNGKey(0)), 1)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return jm, jp, tm, tp


def _inputs(cfg, B=2, T=24, S=8, seed=3):
    frames = make_frames(cfg.d_model, B, T, seed=seed)
    toks = make_prompts(cfg.vocab_size, B, S, seed=seed)
    return frames, toks


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_layernorm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = np.asarray(jax_layernorm(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias)))
    got = layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                    torch.from_numpy(bias)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    bf = layernorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                   torch.from_numpy(bias))
    assert bf.dtype == torch.bfloat16


def test_sinusoids_and_make_frames_equal_jax():
    np.testing.assert_array_equal(encdec.sinusoids(37, 64),
                                  jencdec.sinusoids(37, 64))
    np.testing.assert_array_equal(encdec.sinusoids(1500, 1024),
                                  jencdec.sinusoids(1500, 1024))
    np.testing.assert_array_equal(make_frames(64, 2, 37, seed=5),
                                  jax_frames(64, 2, 37, seed=5))


def test_param_tree_cache_and_specs(whisper):
    jm, jp, tm, tp = whisper
    cfg = tm.cfg
    assert (cfg.family, cfg.n_layers, cfg.dec_layers, cfg.max_dec_len) == (
        "encdec", 2, 2, 16)
    assert tm.is_encdec and not tm.supports_paged_kv
    assert not supports_streamed_prefill(tm)
    assert set(tp) == {"embed", "dec_pos", "enc_layers", "dec_layers",
                       "enc_ln", "dec_ln"}
    assert set(tp["dec_layers"][0]) == {"ln1", "self_attn", "ln2",
                                        "cross_attn", "ln3", "mlp"}
    assert "bk" not in tp["enc_layers"][0]["attn"]
    specs = dict(named_leaves(tm.param_specs()))
    mine = dict(named_leaves(tp))
    assert set(specs) == set(mine)
    assert all(specs[k].shape == mine[k].shape for k in specs)
    drawn = dict(named_leaves(tm.init_params(seed=0)))
    assert all(drawn[k].shape == mine[k].shape for k in specs)
    cache = tm.make_cache(3, 24)
    want = jm.make_cache(3, 24)
    for path, leaf in named_leaves(cache):
        g, k = path.split(".")
        assert tuple(leaf.shape) == tuple(want[g][k].shape), path
    assert cache["self_kv"]["k"].shape[2] == cfg.max_dec_len
    inp = tm.input_specs("prefill", 2, 40)
    assert inp["frames"].shape == (2, 40, 64) and inp["frames"].is_meta
    assert inp["tokens"].shape == (2, 16)
    assert tm.input_specs("decode", 2, 40)["tokens"].shape == (2, 1)


def test_full_config_and_device_default():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.dec_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.max_dec_len) == (
        24, 24, 1024, 16, 64, 4096, 51865, 448)
    n = sum(t.numel() for _, t in named_leaves(
        get_model(ARCH, device="cpu").param_specs()))
    assert 0.75e9 < n < 0.78e9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model(ARCH)


def test_encode_matches_jax(whisper):
    jm, jp, tm, tp = whisper
    frames, _ = _inputs(tm.cfg, T=37)
    want = jencdec.encode(jp, jm.cfg, jnp.asarray(frames))
    got = encdec.encode(tp, tm.cfg, torch.from_numpy(frames))
    _close_rel(got, want, ENC_RTOL)


def test_forward_matches_jax(whisper):
    jm, jp, tm, tp = whisper
    frames, toks = _inputs(tm.cfg, T=24, S=12)
    jl, _ = jm.forward(jp, {"frames": jnp.asarray(frames),
                            "tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"frames": frames, "tokens": toks})
    _close_rel(tl, jl, LOGIT_RTOL)
    assert float(aux) == 0.0


def test_prefill_then_decode_matches_jax(whisper):
    """prefill over 24 frames and 4 prompt tokens (logits and both caches),
    then greedy decode to the last decoder position."""
    jm, jp, tm, tp = whisper
    frames, toks = _inputs(tm.cfg, T=24, S=4)
    jl, jc = jm.prefill(jp, {"frames": jnp.asarray(frames),
                             "tokens": jnp.asarray(toks)}, jm.make_cache(2, 24))
    tl, tc = tm.prefill(tp, {"frames": frames, "tokens": toks},
                        tm.make_cache(2, 24))
    _close_rel(tl, jl, LOGIT_RTOL)
    for g in ("self_kv", "cross_kv"):
        for k in ("k", "v"):
            _close_rel(tc[g][k], jc[g][k], LOGIT_RTOL)
    jtok, ttok = _greedy(jl), tl.argmax(-1).to(torch.int32).numpy()
    np.testing.assert_array_equal(ttok, jtok)
    for pos in range(4, tm.cfg.max_dec_len):
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(jtok[:, None])},
                                jnp.int32(pos))
        tl, tc = tm.decode_step(tp, tc, {"tokens": ttok[:, None]}, pos)
        _close_rel(tl, jl, LOGIT_RTOL)
        jtok, ttok = _greedy(jl), tl.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(ttok, jtok)
    _close_rel(tc["self_kv"]["k"], jc["self_kv"]["k"], LOGIT_RTOL)


def test_prefill_then_decode_matches_own_forward(whisper):
    """The port's cached path against its own teacher-forced ``forward``
    (tests/test_models.py's check of the JAX package)."""
    _, _, tm, tp = whisper
    B, S, PRE = 2, 16, 8
    frames, toks = _inputs(tm.cfg, B=B, T=8, S=S, seed=7)
    full, _ = tm.forward(tp, {"frames": frames, "tokens": toks})
    lg, cache = tm.prefill(tp, {"frames": frames, "tokens": toks[:, :PRE]},
                           tm.make_cache(B, 8))
    errs = [float((lg - full[:, PRE - 1]).abs().max())]
    for pos in range(PRE, S):
        lg, cache = tm.decode_step(tp, cache,
                                   {"tokens": toks[:, pos:pos + 1]}, pos)
        errs.append(float((lg - full[:, pos]).abs().max()))
    assert max(errs) <= LOGIT_RTOL * float(full.abs().max()), errs


def test_prefill_replaces_a_cross_cache_of_another_length(whisper):
    """The JAX prefill returns the cross K/V it computed whatever the
    cache held; the port replaces leaves of another length."""
    _, _, tm, tp = whisper
    frames, toks = _inputs(tm.cfg, T=13, S=3)
    lg, cache = tm.prefill(tp, {"frames": frames, "tokens": toks},
                           tm.make_cache(2, 5))
    want, _ = tm.prefill(tp, {"frames": frames, "tokens": toks},
                         tm.make_cache(2, 13))
    assert cache["cross_kv"]["k"].shape[2] == 13
    assert torch.equal(lg, want)


def test_engine_generate_matches_jax_engine(whisper):
    jm, jp, tm, tp = whisper
    prompts = make_prompts(tm.cfg.vocab_size, 2, 4, seed=3)
    frames = make_frames(tm.cfg.d_model, 2, 37, seed=3)
    want = JaxEngine(jm, jp, donate_cache=False).generate(
        prompts, max_new_tokens=10, frames=frames)
    got = Engine(tm, tp).generate(prompts, max_new_tokens=10, frames=frames)
    assert got.tokens.shape == (2, 10)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    # the whole decoder window: positions up to max_dec_len - 1
    full = Engine(tm, tp).generate(prompts, max_new_tokens=13, frames=frames)
    np.testing.assert_array_equal(full.tokens[:, :10], want.tokens)


# ---------------------------------------------------------------------------
# what enc-dec refuses, as the JAX package does
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["continuous", "paged_cache", "prefill_from",
                                  "vector_pos", "past_max_dec_len"])
def test_encdec_refusals(whisper, what):
    _, _, tm, tp = whisper
    frames, toks = _inputs(tm.cfg, T=8, S=4)
    if what == "continuous":
        with pytest.raises(NotImplementedError, match="sequential Engine"):
            ContinuousBatchingEngine(tm, tp)
    elif what == "paged_cache":
        with pytest.raises(ValueError, match="no paged KV layout"):
            tm.make_paged_cache(4, 8)
    elif what == "prefill_from":
        with pytest.raises(ValueError, match="suffix-only"):
            tm.prefill_from(tp, {"tokens": toks}, tm.make_cache(2, 8), 2)
    elif what == "vector_pos":
        _, cache = tm.prefill(tp, {"frames": frames, "tokens": toks},
                              tm.make_cache(2, 8))
        for pos in ([4, 4], np.array([4, 5]), torch.tensor([4, 4])):
            with pytest.raises(ValueError, match="scalar"):
                tm.decode_step(tp, cache, {"tokens": toks[:, :1]}, pos)
    else:
        # 4 + 13 - 1 = 16 positions fit max_dec_len 16; one more does not
        with pytest.raises(ValueError, match="max_dec_len"):
            Engine(tm, tp).generate(toks, max_new_tokens=14, frames=frames)
        _, cache = tm.prefill(tp, {"frames": frames, "tokens": toks},
                              tm.make_cache(2, 8))
        with pytest.raises(ValueError, match="max_dec_len"):
            tm.decode_step(tp, cache, {"tokens": toks[:, :1]}, 16)


def test_faas_invocation_fails_as_in_jax(whisper):
    """A whisper function deploys (no prewarm) and its invocation raises
    where the continuous engine is built, with the JAX runtime's error
    type."""
    jm, jp, tm, tp = whisper
    prompt = np.arange(4, dtype=np.int32)
    jrt = JaxRuntime(max_len=32)
    jrt.deploy(jax_api.static_function("w", jm, jp), {})
    with pytest.raises(Exception) as jerr:
        jrt.submit("w", {}, prompt, 3)
    rt = FaaSRuntime(max_len=32, device="cpu")
    rt.deploy(tidal.static_function("w", tm, tp), {})
    assert "w" in rt.server.templates
    with pytest.raises(Exception) as terr:
        rt.submit("w", {}, prompt, 3)
    assert type(terr.value) is type(jerr.value) is NotImplementedError
    assert str(terr.value) == str(jerr.value)


def test_serve_cli_exits_for_encdec():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="sequential Engine"):
        serve.main(["--arch", ARCH, "--device", "cpu"])


# ---------------------------------------------------------------------------
# converter and template
# ---------------------------------------------------------------------------

def test_convert_round_trips_every_whisper_leaf(whisper):
    jm, jp, tm, tp = whisper
    lengths = convert.group_lengths(tp)
    assert lengths == {"enc_blocks": 2, "dec_blocks": 2}
    flat_jax = {p: np.asarray(v) for p, v in convert._flatten(
        jax.tree.map(np.asarray, jp))}
    seen = set()
    for name, t in convert.named_parameters(tp):
        path, layer = convert.jax_key(name)
        assert name in convert.port_names(path, lengths)
        want = flat_jax[path][layer] if layer else flat_jax[path]
        np.testing.assert_array_equal(t.numpy(), want)
        seen.add(path)
    assert seen == set(flat_jax)
    assert convert.port_names("dec_blocks.cross_attn.wk", lengths) == [
        "dec_layers.0.cross_attn.wk", "dec_layers.1.cross_attn.wk"]
    assert convert.jax_key("enc_layers.1.mlp.b2") == ("enc_blocks.mlp.b2", (1,))
    assert convert.jax_key("dec_pos") == ("dec_pos", ())
    full = convert.group_lengths(get_model(ARCH, device="cpu").param_specs())
    assert full == {"enc_blocks": 24, "dec_blocks": 24}
    bad = jax.tree.map(np.asarray, jp)
    bad["dec_blocks"]["ln3"]["bias"] = np.concatenate(
        [bad["dec_blocks"]["ln3"]["bias"]] * 2)
    with pytest.raises(ValueError, match="dec_blocks entries"):
        convert.params_from_jax(bad, tm.cfg, device="cpu")


def test_template_order_equals_the_reference(whisper):
    jm, jp, tm, tp = whisper
    jsrv = JaxServer(trace_batch=1, trace_seq=16)
    want = jsrv.register(jax_api.static_function("w", jm, jp), {})
    srv = TemplateServer(trace_batch=1, trace_seq=16)
    got = srv.register(tidal.static_function("w", tm, tp), {})
    assert [convert.jax_key(p) for p, _ in got.static_order] == list(
        want.static_order)
    assert not got.dynamic
    # cross K/V of every decoder layer come right after the encoder
    paths = [p for p, _ in got.static_order]
    first_embed = paths.index("embed")
    assert paths[first_embed - 1] == "dec_layers.1.cross_attn.bv"


# ---------------------------------------------------------------------------
# kernel launches of whisper-medium, on meta tensors
# ---------------------------------------------------------------------------

class _Calls:
    quiet = 0

    def __init__(self):
        self.calls = []

    def kernel(self, name, inputs):
        self.calls.append((name, tuple(inputs[0].shape), tuple(inputs[1].shape)))


def test_kernel_launches_per_prefill_and_decode_step():
    """One prefill of 8 x 1,500 frames and 4 tokens: 24 encoder flash
    launches (1,500 over 1,500), 24 decoder self (4 over 4) and 24 cross
    (4 over 1,500); one decode step: 48 ``decode_attention`` over 448 and
    1,500 rows.  No other kernel."""
    model = get_model(ARCH, device="cpu")
    specs = model.param_specs()
    inputs = model.input_specs("prefill", 8, 1500)
    inputs["tokens"] = inputs["tokens"][:, :4]
    cache = model.make_cache(8, 1500, device="meta")
    obs = _Calls()
    meta.add_observer(obs)
    try:
        model.prefill(specs, inputs, cache)
        n_prefill = len(obs.calls)
        model.decode_step(specs, cache, model.input_specs("decode", 8, 1), 4)
    finally:
        meta.remove_observer(obs)
    pre, step = obs.calls[:n_prefill], obs.calls[n_prefill:]
    assert [c[0] for c in pre] == ["flash_attention"] * 72
    enc = (8, 16, 1500, 64)
    dec = (8, 16, 4, 64)
    assert pre[:24] == [("flash_attention", enc, enc)] * 24
    assert pre[24:] == [("flash_attention", dec, dec),
                        ("flash_attention", dec, enc)] * 24
    assert step == [("decode_attention", (8, 16, 64), (8, 16, 448, 64)),
                    ("decode_attention", (8, 16, 64), (8, 16, 1500, 64))] * 24
