"""The port's xLSTM pieces and model, held against the JAX package on the
CPU.

* ``mlstm_mixer`` (S = 1, 16 and 32; ``ssm_chunk`` 128 and 8, so one
  chunk or several; from a fresh or a carried state) and
  ``mlstm_chunked`` with gates that drive the stabiliser to its extremes
  (``i_raw`` near +30, ``f_raw`` very negative), against
  ``repro.models.ssm``: outputs and every state leaf within 1e-5 of the
  largest |value|; a length that is not a multiple of the chunk raises in
  both packages;
* ``slstm_mixer`` from a fresh or a carried state, the same tolerance;
* the smoke xlstm (3 mLSTM + 1 sLSTM blocks, d 64, 4 heads, fp32;
  ``ssm_chunk`` 128 and 8; weights from ``convert.params_from_jax``):
  forward, prefill (logits and every cache leaf) and 8 decode steps
  within 2e-4 of the JAX ``Model``, identical greedy tokens; the cache
  layout and the ``EMPTY_M`` start; a batched prefill equal bit for bit
  to each sequence's alone; the positional and banked paths refused;
* ``convert``: a round trip, the port names of the full config's 42
  mLSTM and 6 sLSTM blocks from its parameter specs (no weights), and
  ``apply_lora`` on ``mlstm.mixer.wq`` against the JAX merge;
* the rmsnorm launches of one model call, counted on ``meta`` tensors:
  10 for the smoke model (1 with the residual add fused), 103 for
  xlstm-1.3b (6 fused).

Inputs are drawn with numpy from fixed seeds.  TF32 is off.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.api as jax_api  # noqa: E402
import repro_torch.core.api as torch_api  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import meta  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402
from repro_torch.utils import named_leaves  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
RTOL = 1e-5                     # mixers and states: of the largest |value|
ATOL = 2e-4                     # model logits and caches
ARCH = "xlstm-1.3b"


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _close_rel(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=0)


def _random_params(tree_fn, cfg, seed):
    """A parameter dict of the port's shapes with numpy normals (fan-in
    scaled; norms and biases near 1 and 0), as (JAX, port) pairs."""
    rng = np.random.default_rng(seed)
    specs = dict(named_leaves(tree_fn(None, cfg)))
    flat = {}
    for path, t in specs.items():
        shape = tuple(t.shape)
        leaf = path.rsplit(".", 1)[-1]
        if leaf == "norm":
            a = 1 + 0.1 * rng.standard_normal(shape)
        elif leaf in ("b_if", "b"):
            a = 0.5 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        flat[path] = a.astype(np.float32)

    def nest(conv):
        out: dict = {}
        for path, a in flat.items():
            node = out
            *heads, last = path.split(".")
            for h in heads:
                node = node.setdefault(h, {})
            node[last] = conv(a)
        return out
    return nest(jnp.asarray), nest(_t)


def _states(shapes: dict, rng, scale=0.3):
    st = {k: (rng.standard_normal(s) * scale).astype(np.float32)
          for k, s in shapes.items()}
    if "C" in st:                     # a running max of log weights
        st["m"] = (rng.standard_normal(shapes["m"]) - 2).astype(np.float32)
    return st


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [128, 8])
@pytest.mark.parametrize("S", [1, 16, 32])
def test_mlstm_mixer_matches_jax(S, chunk, with_state):
    cfg_t = torch_smoke(ARCH, device="cpu", ssm_chunk=chunk).cfg
    cfg_j = jax_smoke(ARCH, ssm_chunk=chunk).cfg
    jp, tp = _random_params(ssm.make_mlstm_params, cfg_t, 1)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, S, cfg_t.d_model)) * 0.5).astype(np.float32)
    state = _states(ssm.mlstm_state_shape(cfg_t, 2), rng) if with_state else None
    jy, jst = jssm.mlstm_mixer(jp, jnp.asarray(x), cfg_j,
                               None if state is None else
                               {k: jnp.asarray(v) for k, v in state.items()})
    ty, tst = ssm.mlstm_mixer(tp, _t(x), cfg_t,
                              None if state is None else
                              {k: _t(v) for k, v in state.items()})
    _close_rel(ty, jy)
    assert set(tst) == set(jst) == {"C", "n", "m", "conv"}
    for k in jst:
        _close_rel(tst[k], jst[k])
        assert tst[k].dtype == (torch.float32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S,chunk", [(16, 16), (32, 8)])
def test_mlstm_chunked_extreme_gates_match_jax(S, chunk, with_state):
    """Input gates near +30 and forget gates far below 0: the stabiliser
    ``m`` sits at the input gates, the -30 clamps and ``exp(-m)`` in the
    denominator are all exercised."""
    rng = np.random.default_rng(3)
    B, H, dh = 2, 3, 8
    q, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    i_raw = (30 + rng.standard_normal((B, S, H))).astype(np.float32)
    f_raw = (-40 + 5 * rng.standard_normal((B, S, H))).astype(np.float32)
    i_raw[:, ::3] = -60.0                # some rows far below the clamp
    state = None
    if with_state:
        state = _states({"C": (B, H, dh, dh), "n": (B, H, dh), "m": (B, H)}, rng)
        state["m"][0] = ssm.EMPTY_M
    jy, jst = jssm._mlstm_chunked(*map(jnp.asarray, (q, k, v, i_raw, f_raw)),
                                  chunk, None if state is None else
                                  {kk: jnp.asarray(vv) for kk, vv in state.items()})
    ty, tst = ssm.mlstm_chunked(*map(_t, (q, k, v, i_raw, f_raw)), chunk,
                                None if state is None else
                                {kk: _t(vv) for kk, vv in state.items()})
    assert np.isfinite(ty.numpy()).all()
    _close_rel(ty, jy)
    for kk in ("C", "n", "m"):
        _close_rel(tst[kk], jst[kk])


def test_mlstm_length_rule_raises_in_both():
    """S = 40 at chunk 16: neither a single chunk nor a multiple of it."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 40, 2, 8)).astype(np.float32)
    g = rng.standard_normal((1, 40, 2)).astype(np.float32)
    with pytest.raises(AssertionError):
        jssm._mlstm_chunked(*map(jnp.asarray, (q, q, q, g, g)), 16)
    with pytest.raises(ValueError, match="not a multiple of the chunk 16"):
        ssm.mlstm_chunked(*map(_t, (q, q, q, g, g)), 16)
    # a single chunk shorter than ``chunk`` and a whole multiple both run
    ssm.mlstm_chunked(*map(_t, (q, q, q, g, g)), 64)
    ssm.mlstm_chunked(*map(_t, (q, q, q, g, g)), 8)


@pytest.mark.parametrize("S,with_state", [(12, False), (12, True), (1, True)])
def test_slstm_mixer_matches_jax(S, with_state):
    cfg_t = torch_smoke(ARCH, device="cpu").cfg
    cfg_j = jax_smoke(ARCH).cfg
    jp, tp = _random_params(ssm.make_slstm_params, cfg_t, 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, S, cfg_t.d_model)).astype(np.float32)
    state = _states(ssm.slstm_state_shape(cfg_t, 2), rng) if with_state else None
    if state is not None:
        state["n"] = np.abs(state["n"])           # a normaliser sum
    jy, jst = jssm.slstm_mixer(jp, jnp.asarray(x), cfg_j,
                               None if state is None else
                               {k: jnp.asarray(v) for k, v in state.items()})
    ty, tst = ssm.slstm_mixer(tp, _t(x), cfg_t,
                              None if state is None else
                              {k: _t(v) for k, v in state.items()})
    _close_rel(ty, jy)
    assert set(tst) == set(jst) == {"c", "n", "h", "m"}
    for k in jst:
        _close_rel(tst[k], jst[k])


# ---------------------------------------------------------------------------
# the smoke xlstm model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[128, 8], ids=["chunk128", "chunk8"])
def xlstm(request):
    chunk = request.param
    jm = jax_smoke(ARCH, ssm_chunk=chunk)
    tm = torch_smoke(ARCH, device="cpu", ssm_chunk=chunk)
    jp = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    # zero gate biases would leave the stabiliser near its start
    jp["mlstm"]["mixer"]["b_if"] = jnp.asarray(
        rng.standard_normal(jp["mlstm"]["mixer"]["b_if"].shape).astype(np.float32))
    jp["slstm"]["mixer"]["b"] = jnp.asarray(
        (0.5 * rng.standard_normal(jp["slstm"]["mixer"]["b"].shape)).astype(np.float32))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return jm, jp, tm, tp


def _jax_cache_leaves(cache):
    return {f"{g}.{k}": np.asarray(v) for g, sub in cache.items()
            for k, v in sub.items()}


def test_xlstm_param_tree_and_cache_layout(xlstm):
    jm, jp, tm, tp = xlstm
    cfg = tm.cfg
    assert (cfg.family, cfg.n_layers, cfg.slstm_every) == ("xlstm", 4, 4)
    assert transformer.xlstm_units(cfg) == (1, 3)
    assert set(tp) == {"embed", "mlstm", "slstm", "final_norm", "lm_head"}
    assert len(tp["mlstm"]) == 3 and len(tp["slstm"]) == 1
    assert set(tp["slstm"][0]) == {"norm", "mlp_norm", "mixer"}
    assert set(tp["slstm"][0]["mixer"]["mlp"]) == {"w_gate", "w_up", "w_down"}
    specs = dict(named_leaves(tm.param_specs()))
    mine = dict(named_leaves(tp))
    assert set(specs) == set(mine)
    assert all(specs[k].shape == mine[k].shape for k in specs)
    cache = tm.make_cache(3, 24)
    want = jm.make_cache(3, 24)
    for path, leaf in named_leaves(cache):
        g, k = path.split(".")
        assert tuple(leaf.shape) == tuple(want[g][k].shape), path
        assert str(leaf.dtype)[6:] == str(want[g][k].dtype), path
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[g][k]))
    assert (cache["mlstm"]["m"] == ssm.EMPTY_M).all()
    assert not cache["slstm"]["m"].any()
    assert not tm.supports_paged_kv
    with pytest.raises(ValueError, match="paged"):
        tm.make_paged_cache(4, 8)
    for extra in ({"n_layers": 2}, {"n_layers": 6}, {"slstm_every": 0}):
        with pytest.raises(ValueError, match="whole number of units"):
            torch_smoke(ARCH, device="cpu", **extra)


def test_xlstm_forward_matches_jax(xlstm):
    jm, jp, tm, tp = xlstm
    toks = np.random.default_rng(10).integers(0, tm.cfg.vocab_size, (2, 32)
                                              ).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, training=False)
    tl, _ = tm.forward(tp, {"tokens": toks})
    _close(tl, jl)


def test_xlstm_prefill_and_decode_match_jax(xlstm):
    """prefill at S = 32 (one chunk, or four at ``ssm_chunk`` 8): last
    logits and every cache leaf; then 8 greedy decode steps."""
    jm, jp, tm, tp = xlstm
    B, S, T = 2, 32, 48
    toks = np.random.default_rng(11).integers(0, tm.cfg.vocab_size, (B, S)
                                              ).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.make_cache(B, T))
    tl, tc = tm.prefill(tp, {"tokens": toks}, tm.make_cache(B, T))
    _close(tl, jl)
    jleaves = _jax_cache_leaves(jc)
    tleaves = dict(named_leaves(tc))
    assert set(jleaves) == set(tleaves)
    for k in jleaves:
        _close(tleaves[k], jleaves[k])
    jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    ttok = tl.argmax(-1).to(torch.int32).numpy()
    np.testing.assert_array_equal(ttok, jtok)
    for i in range(8):
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(jtok[:, None])},
                                jnp.int32(S + i))
        tl, tc = tm.decode_step(tp, tc, {"tokens": ttok[:, None]}, S + i)
        _close(tl, jl)
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        ttok = tl.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(ttok, jtok)
    for k, v in _jax_cache_leaves(jc).items():
        _close(dict(named_leaves(tc))[k], v)


def test_xlstm_batched_prefill_equals_each_sequence_alone(xlstm):
    """A prefill of several sequences runs them one at a time, so each
    sequence gets the bits it gets alone (the serving engine's batch-1
    prefill), logits and every state leaf."""
    _, _, tm, tp = xlstm
    toks = np.random.default_rng(14).integers(0, 256, (3, 16)).astype(np.int32)
    lg, cache = tm.prefill(tp, {"tokens": toks}, tm.make_cache(3, 24))
    for b in range(3):
        lg1, c1 = tm.prefill(tp, {"tokens": toks[b:b + 1]}, tm.make_cache(1, 24))
        assert torch.equal(lg[b:b + 1], lg1)
        for (pa, a), (pb, one) in zip(named_leaves(cache), named_leaves(c1)):
            assert pa == pb and torch.equal(a[:, b:b + 1], one), pa


def test_xlstm_refuses_positional_and_banked_paths(xlstm):
    _, _, tm, tp = xlstm
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="suffix-only"):
        tm.prefill_from(tp, {"tokens": toks}, tm.make_cache(1, 16), 4)
    with pytest.raises(ValueError, match="paged decode"):
        transformer.decode_step_paged(tp, tm.cfg, {},
                                      torch.zeros((1, 1), dtype=torch.int32),
                                      torch.zeros(1, dtype=torch.int32),
                                      torch.zeros((1, 2), dtype=torch.int32), 8)
    with pytest.raises(NotImplementedError, match="adapter"):
        tm.prefill(tp, {"tokens": toks}, tm.make_cache(1, 16),
                   adapter_bank={"wq": {}}, adapter_ids=[0])


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

def test_convert_round_trips_mlstm_and_slstm(xlstm):
    jm, jp, tm, tp = xlstm
    lengths = convert.group_lengths(tp)
    assert lengths == {"mlstm": 3, "slstm": 1}
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
    bad = jax.tree.map(np.asarray, jp)
    bad["slstm"]["norm"] = np.concatenate([bad["slstm"]["norm"]] * 2)
    with pytest.raises(ValueError, match="slstm entries"):
        convert.params_from_jax(bad, tm.cfg, device="cpu")


def test_port_names_of_the_full_config_from_its_specs():
    """xlstm-1.3b: 42 mLSTM blocks (unit-major: mLSTM ``u*7+j``) and 6
    sLSTM blocks, read from the parameter specs, no weights drawn."""
    cfg = get_config(ARCH)
    specs = transformer.param_specs(cfg)
    lengths = convert.group_lengths(specs)
    assert lengths == {"mlstm": 42, "slstm": 6}
    assert transformer.xlstm_units(cfg) == (6, 7)
    names = convert.port_names("mlstm.mixer.wq", lengths)
    assert names == [f"mlstm.{i}.mixer.wq" for i in range(42)]
    assert convert.port_names("slstm.mixer.mlp.w_down", lengths) == [
        f"slstm.{u}.mixer.mlp.w_down" for u in range(6)]
    assert convert.port_names("final_norm", lengths) == ["final_norm"]
    ports = dict(named_leaves(specs))
    for name in ports:
        path, layer = convert.jax_key(name)
        assert name in convert.port_names(path, lengths)
        if layer:
            assert convert.port_names(path, lengths)[layer[0]] == name
    assert tuple(ports["mlstm.41.mixer.wq"].shape) == (4096, 4096)
    assert tuple(ports["slstm.5.mixer.r"].shape) == (4, 512, 2048)
    total = sum(t.numel() for t in ports.values())
    assert 3.60e9 < total < 3.62e9                 # 3.61 B parameters


def test_apply_lora_on_mlstm_wq_matches_jax(xlstm):
    jm, jp, tm, tp = xlstm
    target = ["mlstm.mixer.wq"]
    jfn = jax_api.lora_function("f", jm, jp, target, n_adapters=2)
    tfn = torch_api.lora_function("f", tm, tp, target, n_adapters=2)
    jtraced, _ = jfn.run_initializer({"adapter": "adapter-1"})
    ttraced, _ = tfn.run_initializer({"adapter": "adapter-1"})
    jwq = jtraced["mlstm"]["mixer"]["wq"].materialize()
    base = np.asarray(jp["mlstm"]["mixer"]["wq"])
    for i in range(3):
        got = ttraced["mlstm"][i]["mixer"]["wq"].materialize().numpy()
        np.testing.assert_allclose(got, jwq[i], atol=1e-6, rtol=0)
        assert np.abs(got - base[i]).max() > 1e-5
    np.testing.assert_array_equal(
        ttraced["mlstm"][0]["mixer"]["wk"].materialize().numpy(),
        np.asarray(jp["mlstm"]["mixer"]["wk"])[0])


# ---------------------------------------------------------------------------
# rmsnorm launches of one model call, on meta tensors
# ---------------------------------------------------------------------------

class _NormCounter:
    quiet = 0

    def __init__(self):
        self.calls = []

    def kernel(self, name, inputs):
        self.calls.append((name, len(inputs)))


def _meta_norms(cfg, S: int, B: int = 1) -> tuple:
    """(rmsnorm calls, fused ones, other kernels) of one prefill of B
    sequences of S tokens and of one decode step of 2 sequences, through
    ``ops`` on ``meta`` tensors."""
    specs = transformer.param_specs(cfg)
    out = []
    for step in ("prefill", "decode"):
        cache = transformer.make_cache(cfg, B if step == "prefill" else 2, 16,
                                       device="meta")
        obs = _NormCounter()
        meta.add_observer(obs)
        try:
            if step == "prefill":
                toks = torch.zeros((B, S), dtype=torch.int32, device="meta")
                transformer.prefill(specs, cfg, toks, cache)
            else:
                toks = torch.zeros((2, 1), dtype=torch.int32, device="meta")
                transformer.decode_step(specs, cfg, cache, toks, 5)
        finally:
            meta.remove_observer(obs)
        norms = [n for name, n in obs.calls if name == "rmsnorm"]
        out.append((len(norms), norms.count(3),
                    sorted({name for name, _ in obs.calls} - {"rmsnorm"})))
    return out


@pytest.mark.parametrize("arch_cfg,want", [
    ("smoke", (10, 1)),
    ("full", (103, 6)),
])
def test_rmsnorm_launches_per_model_call(arch_cfg, want):
    """Two per mLSTM block (pre-norm, inner norm), three per sLSTM block
    (pre-norm, inner norm, ``mlp_norm`` with the residual fused) and the
    final norm; no attention kernel and no ``ssd_scan``."""
    cfg = (torch_smoke(ARCH, device="cpu").cfg if arch_cfg == "smoke"
           else get_config(ARCH))
    for n, fused, others in _meta_norms(cfg, 8):
        assert (n, fused) == want
        assert others == []
    # a prefill of 3 sequences runs them one at a time: three calls' worth
    (n, fused, _), _ = _meta_norms(cfg, 8, B=3)
    assert (n, fused) == (3 * want[0], 3 * want[1])
