"""The port's Mamba2 pieces and zamba model, held against the JAX package
on the CPU.

* SSD plain versions (``kernels/ref.py``): the chunked one against the
  Pallas ``ssd_scan`` in interpret mode (S a multiple of the chunk) and
  both against ``repro.kernels.ref.ssd_scan_ref``, within 1e-5 of the
  largest |y| and |h| (fp32; the two orders of summation differ only in
  rounding); ragged S against the JAX sequential reference;
* ``causal_conv1d``, ``mamba2_mixer`` (chunked, ragged and decode
  branches) against ``repro.models.ssm``;
* the smoke zamba (4 layers, ``attn_every`` 2, d 64, 4 SSM heads, state
  16, chunk 16; fp32; weights from ``convert.params_from_jax``): forward,
  prefill (logits and every cache leaf) and decode within 2e-4 of the
  JAX ``Model``, identical greedy tokens over 8 steps;
* ``convert`` round-trips ``mamba.*`` and ``shared_attn.*``;
* the ``ssd_scan`` wrapper's ``meta`` report for the tracer.

Inputs are drawn with numpy from fixed seeds.  TF32 is off.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import meta, ops, ref  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402
from repro_torch.utils import named_leaves  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
SSD_RTOL = 1e-5                 # of the largest |y| and |h|
ATOL = 2e-4                     # model logits and caches
ARCH = "zamba2-2.7b"


def _ssd_inputs(B, S, H, dh, ds, seed, with_h0):
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, ds)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, ds)) * 0.3).astype(np.float32)
    ld = (-np.abs(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((B, H, dh, ds)).astype(np.float32)
          if with_h0 else None)
    return xb, Bm, Cm, ld, h0


def _close_rel(got, want, rtol=SSD_RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# SSD plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,H,S,dh,ds,Q", [
    (1, 2, 64, 32, 16, 16),
    (2, 4, 128, 64, 64, 32),
    (1, 3, 48, 16, 32, 48),
    (2, 1, 96, 32, 16, 96),
])
def test_ssd_plain_versions_match_pallas_and_sequential(B, H, S, dh, ds, Q,
                                                        with_h0):
    xb, Bm, Cm, ld, h0 = _ssd_inputs(B, S, H, dh, ds, 1, with_h0)
    y_c, h_c = ref.ssd_chunked_ref(_t(xb), _t(Bm), _t(Cm), _t(ld), Q, _t(h0))
    y_s, h_s = ref.ssd_scan_ref(_t(xb), _t(Bm), _t(Cm), _t(ld), _t(h0))
    jy, jh = jref.ssd_scan_ref(jnp.asarray(xb), jnp.asarray(Bm), jnp.asarray(Cm),
                               jnp.asarray(ld),
                               None if h0 is None else jnp.asarray(h0))
    _close_rel(y_c, jy)
    _close_rel(h_c, jh)
    _close_rel(y_s, jy)
    _close_rel(h_s, jh)
    if h0 is None:            # the Pallas kernel always starts from zeros
        py, ph = pallas_ssd_scan(jnp.moveaxis(jnp.asarray(xb), 1, 2),
                                 jnp.asarray(Bm), jnp.asarray(Cm),
                                 jnp.moveaxis(jnp.asarray(ld), 1, 2),
                                 chunk=Q, interpret=True)
        _close_rel(y_c, jnp.moveaxis(py, 1, 2))
        _close_rel(h_c, ph)
    # the wrapper's CPU path is the chunked version here
    y_w, h_w = ops.ssd_scan(_t(xb), _t(Bm), _t(Cm), _t(ld), Q, _t(h0))
    assert torch.equal(y_w, y_c) and torch.equal(h_w, h_c)


@pytest.mark.parametrize("S,Q", [(37, 16), (5, 16), (130, 128)])
def test_ssd_ragged_length_matches_jax_sequential(S, Q):
    """S not a multiple of the chunk: the wrapper's CPU path is the exact
    recurrence, held against the JAX sequential reference, h0 given."""
    xb, Bm, Cm, ld, h0 = _ssd_inputs(2, S, 3, 16, 16, 2, True)
    y, h = ops.ssd_scan(_t(xb), _t(Bm), _t(Cm), _t(ld), Q, _t(h0))
    jy, jh = jref.ssd_scan_ref(jnp.asarray(xb), jnp.asarray(Bm), jnp.asarray(Cm),
                               jnp.asarray(ld), jnp.asarray(h0))
    _close_rel(y, jy)
    _close_rel(h, jh)


def test_ssd_chunk_size_invariance():
    """One sequence through several chunk sizes gives one answer."""
    xb, Bm, Cm, ld, h0 = _ssd_inputs(1, 64, 2, 16, 8, 3, True)
    y1, h1 = ref.ssd_chunked_ref(_t(xb), _t(Bm), _t(Cm), _t(ld), 64, _t(h0))
    for Q in (8, 16, 32):
        y, h = ref.ssd_chunked_ref(_t(xb), _t(Bm), _t(Cm), _t(ld), Q, _t(h0))
        _close_rel(y, y1)
        _close_rel(h, h1)


def test_ssd_chunked_ref_refuses_ragged_length():
    xb, Bm, Cm, ld, _ = _ssd_inputs(1, 20, 1, 16, 8, 4, False)
    with pytest.raises(ValueError, match="not divisible"):
        ref.ssd_chunked_ref(_t(xb), _t(Bm), _t(Cm), _t(ld), 16)


def test_ssd_scan_meta_report_and_no_launch_on_cpu(monkeypatch):
    """On ``meta`` tensors the wrapper reports itself to the tracer (name
    and input signature, h0 included) and returns empty fp32 outputs of
    the right shapes; on the CPU it launches and counts nothing; on any
    other device it raises."""
    reports = []

    class Obs:
        quiet = 0

        def kernel(self, name, inputs):
            reports.append((name, [tuple(t.shape) for t in inputs]))

    xb = torch.zeros((2, 24, 3, 16), device="meta")
    bc = torch.zeros((2, 24, 40), dtype=torch.bfloat16, device="meta")[..., 8:24]
    ld = torch.zeros((2, 24, 3), device="meta")
    h0 = torch.zeros((2, 3, 16, 16), device="meta")
    obs = Obs()
    meta.add_observer(obs)
    try:
        y, h = ops.ssd_scan(xb, bc, bc, ld, 16, h0)
    finally:
        meta.remove_observer(obs)
    assert (y.shape, h.shape) == ((2, 24, 3, 16), (2, 3, 16, 16))
    assert y.dtype == h.dtype == torch.float32 and y.device.type == "meta"
    assert reports == [("ssd_scan", [(2, 24, 3, 16), (2, 24, 16), (2, 24, 16),
                                     (2, 24, 3), (2, 3, 16, 16)])]
    ops.reset_launch_counts()
    cpu = _ssd_inputs(1, 8, 1, 16, 16, 5, False)[:4]
    ops.ssd_scan(*map(_t, cpu), 4)
    assert ops.launch_counts()["ssd_scan"] == 0
    monkeypatch.setattr(meta, "is_meta", lambda t: False)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd_scan(xb, bc, bc, ld, 16, h0)


# ---------------------------------------------------------------------------
# conv and mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    st = rng.standard_normal((2, 3, 10)).astype(np.float32) if with_state else None
    jy, jst = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 None if st is None else jnp.asarray(st))
    ty, tst = ssm.causal_conv1d(_t(x), _t(w), _t(st))
    np.testing.assert_allclose(ty, jy, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tst, jst)


def _mixer_pair(seed=7):
    cfg_t = torch_smoke(ARCH, device="cpu").cfg
    jm = jax_smoke(ARCH)
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in
              ssm.init_mamba2_params(None, cfg_t).items()}
    p = {k: (rng.standard_normal(s) * (0.5 if k in ("dt_bias", "a_log")
                                       else 1 / np.sqrt(s[0]))).astype(np.float32)
         for k, s in shapes.items()}
    p["d_skip"] = (1 + 0.1 * rng.standard_normal(shapes["d_skip"])).astype(np.float32)
    p["norm"] = (1 + 0.1 * rng.standard_normal(shapes["norm"])).astype(np.float32)
    return jm.cfg, cfg_t, {k: jnp.asarray(v) for k, v in p.items()}, \
        {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("S,with_state", [(32, False), (32, True), (20, True),
                                          (1, True)])
def test_mamba2_mixer_matches_jax(S, with_state):
    """Chunked (S = 32, chunk 16), ragged step (S = 20) and decode (S = 1)
    branches, from zero or from a carried state."""
    jcfg, tcfg, jp, tp = _mixer_pair()
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, S, jcfg.d_model)) * 0.5).astype(np.float32)
    state = None
    if with_state:
        shp = ssm.mamba2_state_shape(tcfg, 2)
        state = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
                 for k, s in shp.items()}
    jy, jst = jssm.mamba2_mixer(jp, jnp.asarray(x), jcfg,
                                None if state is None else
                                {k: jnp.asarray(v) for k, v in state.items()})
    ty, tst = ssm.mamba2_mixer(tp, _t(x), tcfg,
                               None if state is None else
                               {k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tst["h"], jst["h"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tst["conv"], jst["conv"], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the zamba model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba():
    jm = jax_smoke(ARCH, attn_impl="pallas")
    tm = torch_smoke(ARCH, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    # zero dt_bias / a_log would leave the decay path unexercised
    for k in ("dt_bias", "a_log"):
        leaf = jp["mamba"]["mixer"][k]
        jp["mamba"]["mixer"][k] = jnp.asarray(
            (rng.standard_normal(leaf.shape) * 0.5).astype(np.float32))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return jm, jp, tm, tp


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=0)


def _jax_cache_leaves(cache):
    return {f"{g}.{k}": np.asarray(v) for g, sub in cache.items()
            for k, v in sub.items()}


def test_zamba_param_tree_and_cache_layout(zamba):
    jm, jp, tm, tp = zamba
    cfg = tm.cfg
    assert cfg.family == "zamba" and len(tp["mamba"]) == cfg.n_layers == 4
    assert set(tp) == {"embed", "mamba", "shared_attn", "final_norm", "lm_head"}
    assert set(tp["shared_attn"]) == {"attn_norm", "attn", "mlp_norm", "mlp"}
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
    assert not tm.supports_paged_kv
    with pytest.raises(ValueError, match="paged"):
        tm.make_paged_cache(4, 8)


def test_zamba_forward_matches_jax(zamba):
    jm, jp, tm, tp = zamba
    toks = np.random.default_rng(10).integers(0, tm.cfg.vocab_size, (2, 32)
                                              ).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, training=False)
    tl, _ = tm.forward(tp, {"tokens": toks})
    _close(tl, jl)


@pytest.mark.parametrize("S", [32, 21])
def test_zamba_prefill_and_decode_match_jax(zamba, S):
    """prefill (chunked at S = 32, the step branch at S = 21): last logits
    and every cache leaf; then 8 greedy decode steps, scalar position."""
    jm, jp, tm, tp = zamba
    B, T = 2, 48
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


def test_zamba_decode_with_per_slot_positions(zamba):
    """A [B] position vector (continuous batching) gives each sequence the
    logits of its own scalar-position decode."""
    jm, jp, tm, tp = zamba
    rng = np.random.default_rng(12)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    _, tc = tm.prefill(tp, {"tokens": toks}, tm.make_cache(2, 32))
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.make_cache(2, 32))
    nxt = rng.integers(0, tm.cfg.vocab_size, (2, 1)).astype(np.int32)
    pos = np.array([16, 16], np.int32)
    tl, _ = tm.decode_step(tp, tc, {"tokens": nxt}, torch.as_tensor(pos))
    jl, _ = jm.decode_step(jp, jc, {"tokens": jnp.asarray(nxt)}, jnp.asarray(pos))
    _close(tl, jl)


def test_zamba_refuses_positional_and_banked_paths(zamba):
    _, _, tm, tp = zamba
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="suffix-only"):
        tm.prefill_from(tp, {"tokens": toks}, tm.make_cache(1, 16), 4)
    with pytest.raises(ValueError, match="paged decode"):
        transformer.decode_step_paged(tp, tm.cfg, {}, torch.zeros((1, 1), dtype=torch.int32),
                                      torch.zeros(1, dtype=torch.int32),
                                      torch.zeros((1, 2), dtype=torch.int32), 8)
    with pytest.raises(NotImplementedError, match="adapter"):
        tm.prefill(tp, {"tokens": toks}, tm.make_cache(1, 16),
                   adapter_bank={"wq": {}}, adapter_ids=[0])


def test_convert_round_trips_mamba_and_shared_attn(zamba):
    jm, jp, tm, tp = zamba
    L = tm.cfg.n_layers
    flat_jax = {p: np.asarray(v) for p, v in convert._flatten(
        jax.tree.map(np.asarray, jp))}
    seen = set()
    for name, t in convert.named_parameters(tp):
        path, layer = convert.jax_key(name)
        assert name in convert.port_names(path, L)
        want = flat_jax[path][layer] if layer else flat_jax[path]
        np.testing.assert_array_equal(t.numpy(), want)
        seen.add(path)
    assert seen == set(flat_jax)
    assert convert.jax_key("mamba.3.mixer.in_proj") == ("mamba.mixer.in_proj", (3,))
    assert convert.jax_key("shared_attn.attn.wq") == ("shared_attn.attn.wq", ())
    assert convert.port_names("shared_attn.mlp.w_up", L) == ["shared_attn.mlp.w_up"]
    assert convert.port_names("mamba.norm", L) == [f"mamba.{i}.norm" for i in range(L)]
