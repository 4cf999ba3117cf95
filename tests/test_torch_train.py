"""The port's training path, held against the JAX package on the CPU.

The optimizer (plain, factored, clipped, bf16 state), the token stream,
checkpoints (a bf16 state round-trips bit for bit), each family's loss
and every gradient leaf against ``jax.value_and_grad(Model.loss)`` (JAX
weights carried by ``convert.params_from_jax``; the port's gradients run
the flash-attention and rmsnorm backward plain versions), train steps
against ``make_train_step`` with the optimizer state carried by
``convert.opt_state_from_jax``, learning a batch, resume against an
uninterrupted run, the CLI, and the training launch counts of
smollm-135m at full width and depth on ``meta`` tensors.

Tolerances (fp32, TF32 off; summation order only): the loss within 1e-5
relative, each gradient leaf within 1e-4 of its largest |value|,
optimizer states and parameters within 1e-5.
"""

import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenStream as JTokenStream  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_loop import make_train_step as jax_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenStream  # noqa: E402
from repro_torch.kernels import meta  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.train_loop import (TrainLoopConfig, init_train_state,  # noqa: E402
                                          make_train_step, train)
from repro_torch.utils import named_leaves  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest |value|
STATE_TOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_dict(tree) -> dict:
    return {name: t for name, t in named_leaves(tree)}


def _close(got, want, tol=STATE_TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _opt_case(seed: int = 0):
    """A tree with a factorable matrix (at min_factored_size 16), a
    stacked-style [3, 20, 24] leaf, a small matrix and a vector."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (32, 48), "b": {"c": (3, 20, 24), "d": (7,)}, "e": (4, 8)}
    params = jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                          params) for _ in range(10)]
    return params, grads


def _t_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("factored", [False, True])
def test_adamw_ten_steps_match_jax(factored):
    cfg_kw = dict(lr=1e-2, warmup_steps=3, factored=factored,
                  min_factored_size=16)
    jcfg, tcfg = jopt.OptimizerConfig(**cfg_kw), topt.OptimizerConfig(**cfg_kw)
    params, grads = _opt_case()
    jp, tp = jax.tree.map(jnp.asarray, params), _t_tree(params)
    js, ts = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, tcfg)
    if factored:
        assert set(ts["v"]["a"]) == {"row", "col"} and ts["v"]["a"]["row"].shape == (32,)
        assert set(ts["v"]["b"]["c"]) == {"row", "col"}
        assert isinstance(ts["v"]["e"], torch.Tensor)
    for g in grads:
        jp, js, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, tm = topt.adamw_update(tp, _t_tree(g), ts, tcfg)
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])
    for name, got in named_leaves({"p": tp, "m": ts["m"], "v": ts["v"]}):
        want = _leaf_dict({"p": _np_tree(jp), "m": _np_tree(js["m"]),
                           "v": _np_tree(js["v"])})[name]
        _close(got, want, what=name)
    assert int(ts["step"]) == int(js["step"]) == 10


def test_grad_clipping_matches_jax():
    cfg_kw = dict(lr=1e-3, clip_norm=1.0, warmup_steps=1)
    jcfg, tcfg = jopt.OptimizerConfig(**cfg_kw), topt.OptimizerConfig(**cfg_kw)
    jp, tp = {"w": jnp.zeros(4)}, {"w": torch.zeros(4)}
    jp2, _, jm = jopt.adamw_update(jp, {"w": jnp.full(4, 1e6)},
                                   jopt.init_opt_state(jp, jcfg), jcfg)
    tp2, _, tm = topt.adamw_update(tp, {"w": torch.full((4,), 1e6)},
                                   topt.init_opt_state(tp, tcfg), tcfg)
    assert float(tm["grad_norm"]) > 1e6
    assert torch.isfinite(tp2["w"]).all()
    _close(tp2["w"], jp2["w"])


def test_state_dtype_override_matches_jax():
    cfg_kw = dict(state_dtype="bfloat16", lr=1e-2, warmup_steps=1)
    jcfg, tcfg = jopt.OptimizerConfig(**cfg_kw), topt.OptimizerConfig(**cfg_kw)
    params, grads = _opt_case(1)
    jp, tp = jax.tree.map(jnp.asarray, params), _t_tree(params)
    js, ts = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, tcfg)
    assert ts["m"]["a"].dtype == ts["v"]["a"].dtype == torch.bfloat16
    assert ts["m"]["a"].dtype == torch.bfloat16 and js["m"]["a"].dtype == jnp.bfloat16
    for g in grads[:3]:
        jp, js, _ = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, _ = topt.adamw_update(tp, _t_tree(g), ts, tcfg)
    assert tp["a"].dtype == torch.float32 and ts["m"]["a"].dtype == torch.bfloat16
    # both round the same fp32 moments to bf16: equal but for the odd
    # last-bit flip from summation order
    _close(ts["m"]["a"].float(), np.asarray(js["m"]["a"], np.float32), tol=1e-2)
    _close(tp["a"], jp["a"], tol=1e-4)


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------

def test_token_stream_matches_jax_and_resumes():
    kw = dict(vocab_size=100, seq_len=8, global_batch=2, seed=3)
    ts, js = iter(TokenStream(DataConfig(**kw))), iter(JTokenStream(JDataConfig(**kw)))
    for _ in range(3):
        a, b = next(ts), next(js)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
        assert a["tokens"].dtype == np.int32
    s1 = TokenStream(DataConfig(**kw))
    it1 = iter(s1)
    _ = [next(it1) for _ in range(3)]
    saved = s1.state()
    a = next(it1)
    s2 = TokenStream(DataConfig(**kw))
    s2.restore(saved)
    np.testing.assert_array_equal(a["tokens"], next(iter(s2))["tokens"])


def test_checkpoint_roundtrip_and_gc():
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "b": {"c": torch.ones(4)}, "l": [torch.zeros(2, dtype=torch.int32)]}
    with tempfile.TemporaryDirectory() as d:
        for step in (10, 20, 30, 40):
            ckpt.save_checkpoint(d, step, state, extra={"data": {"step": step}},
                                 keep=2)
        assert ckpt.latest_step(d) == 40
        assert len([x for x in os.listdir(d) if x.startswith("step_")]) == 2
        restored, step, extra = ckpt.restore_checkpoint(d, state)
        assert step == 40 and extra["data"]["step"] == 40
        for (na, a), (nb, b) in zip(named_leaves(restored), named_leaves(state)):
            assert na == nb and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 1, {"a": torch.zeros(3)})
        with pytest.raises(ValueError, match="shape mismatch"):
            ckpt.restore_checkpoint(d, {"a": torch.zeros(4)})
        with pytest.raises(FileNotFoundError):
            ckpt.restore_checkpoint(os.path.join(d, "none"), {"a": torch.zeros(3)})


def test_checkpoint_bf16_state_roundtrips_bit_for_bit():
    """A bf16 optimizer state is stored as its raw bits (uint16) with the
    dtype and encoding in the manifest, and reads back bit for bit."""
    p = {"w": torch.randn(64, 32, generator=torch.Generator().manual_seed(0))}
    cfg = topt.OptimizerConfig(state_dtype="bfloat16", lr=1e-2, warmup_steps=1)
    _, st, _ = topt.adamw_update(p, {"w": torch.randn(64, 32)},
                                 topt.init_opt_state(p, cfg), cfg)
    assert st["m"]["w"].dtype == torch.bfloat16 and st["m"]["w"].abs().sum() > 0
    with tempfile.TemporaryDirectory() as d:
        path = ckpt.save_checkpoint(d, 5, {"opt": st})
        import json
        with open(os.path.join(path, "manifest.json")) as f:
            entries = {e["path"]: e for e in json.load(f)["leaves"]}
        assert entries["opt.m.w"]["dtype"] == "bfloat16"
        assert entries["opt.m.w"]["encoding"] == ckpt.BF16_ENCODING
        assert np.load(os.path.join(path, entries["opt.m.w"]["file"])).dtype == np.uint16
        like = {"opt": topt.init_opt_state(p, cfg)}
        back, _, _ = ckpt.restore_checkpoint(d, like)
    for (_, a), (_, b) in zip(named_leaves(back), named_leaves({"opt": st})):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


# ---------------------------------------------------------------------------
# loss and gradients per family
# ---------------------------------------------------------------------------

FAMILIES = ["smollm-135m", "gemma-2b", "qwen3-14b", "phi3.5-moe-42b-a6.6b",
            "deepseek-v3-671b", "zamba2-2.7b", "xlstm-1.3b", "whisper-medium"]
# the reduced configs of these keep their own depth (units / enc + dec)
_OWN_DEPTH = ("zamba2-2.7b", "xlstm-1.3b", "whisper-medium")


def _pair(arch, **extra):
    kw = {} if arch in _OWN_DEPTH else {"n_layers": 2}
    kw.update(extra)
    jm = jax_smoke(arch, **kw)
    tm = torch_smoke(arch, device="cpu", **kw)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(_np_tree(jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _batch(cfg, B=2, S=16, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    if cfg.is_encdec:
        toks = toks[:, :13]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "frames": (rng.standard_normal((B, 24, cfg.d_model)) * 0.1
                           ).astype(np.float32)}
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _port_loss_and_grads(tm, tp, batch):
    leaves = [t for _, t in named_leaves(tp)]
    for t in leaves:
        t.requires_grad_(True)
    loss = tm.loss(tp, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return float(loss.detach()), dict(zip((n for n, _ in named_leaves(tp)), grads))


@pytest.mark.parametrize("arch,remat", [(a, False) for a in FAMILIES]
                         + [("smollm-135m", True), ("phi3.5-moe-42b-a6.6b", True),
                            ("whisper-medium", True)])
def test_loss_and_every_gradient_match_jax(arch, remat):
    """The port's loss (moe: cross-entropy plus 0.01 times the load-
    balancing loss) and the gradient of every parameter against
    ``jax.value_and_grad(Model.loss)``; with ``remat`` both packages
    recompute their checkpointed blocks in the backward."""
    jm, jp, tm, tp = _pair(arch, remat=remat)
    batch = _batch(tm.cfg)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = _port_loss_and_grads(tm, tp, batch)
    assert abs(tl - float(jl)) <= LOSS_RTOL * abs(float(jl))
    want = _leaf_dict(convert.params_from_jax(_np_tree(jg), tm.cfg, device="cpu"))
    assert set(want) == set(tg)
    for name, got in tg.items():
        w = want[name]
        scale = float(w.abs().max())
        err = float((got - w).abs().max())
        assert err <= GRAD_TOL * max(scale, 1e-30), (name, err, scale)
    if tm.cfg.n_experts:
        _, aux = tm.forward(tp, batch)
        _, jaux = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        assert float(aux) > 0 and abs(float(aux) - float(jaux)) <= 1e-5 * float(jaux)


@pytest.mark.parametrize("factored", [False, True])
def test_train_steps_match_jax_make_train_step(factored):
    """One JAX step, the state carried into the port (parameters and the
    optimizer state through ``opt_state_from_jax``), then two steps of
    each: losses, parameters and moments agree."""
    jm, jp, tm, _ = _pair("smollm-135m")
    kw = dict(lr=1e-3, warmup_steps=2, factored=factored, min_factored_size=16)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jstep = jax.jit(jax_train_step(jm, jcfg))
    tstep = make_train_step(tm, tcfg)
    jstate = {"params": jp, "opt": jopt.init_opt_state(jp, jcfg)}
    batches = [_batch(tm.cfg, seed=s) for s in range(3)]
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[0].items()})
    np_state = _np_tree(jstate)
    tstate = {"params": convert.params_from_jax(np_state["params"], tm.cfg, "cpu"),
              "opt": convert.opt_state_from_jax(np_state["opt"], tm.cfg, "cpu")}
    assert int(tstate["opt"]["step"]) == 1
    if factored:
        assert set(tstate["opt"]["v"]["embed"]) == {"row", "col"}
    for b in batches[1:]:
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tstep(tstate, b)
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= STATE_TOL
        _close(tmet["grad_norm"], jmet["grad_norm"], tol=1e-4)
    np_state = _np_tree(jstate)
    want = _leaf_dict({
        "params": convert.params_from_jax(np_state["params"], tm.cfg, "cpu"),
        "opt": convert.opt_state_from_jax(np_state["opt"], tm.cfg, "cpu")})
    for name, got in named_leaves(tstate):
        _close(got, want[name], what=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_learns_the_batch(arch):
    """Two steps on one batch: the loss falls (tests/test_models.py's
    test_train_step for the port), everything finite."""
    m = torch_smoke(arch, device="cpu")
    opt = topt.OptimizerConfig(lr=1e-3, warmup_steps=1)
    state = init_train_state(m, opt, seed=0)
    step = make_train_step(m, opt)
    batch = _batch(m.cfg, seed=1)
    state, m1 = step(state, batch)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m1["grad_norm"]))
    state, m2 = step(state, batch)
    assert float(m2["loss"]) < float(m1["loss"])
    assert all(torch.isfinite(t).all() for _, t in named_leaves(state["params"]))


def test_resume_equals_uninterrupted():
    """Interrupted at step 3 and resumed to 6: the same losses and bits as
    six steps in one run (tests/test_train.py's resume test)."""
    m = torch_smoke("smollm-135m", device="cpu", n_layers=2)
    opt = topt.OptimizerConfig(lr=1e-3, warmup_steps=2)
    data = DataConfig(vocab_size=m.cfg.vocab_size, seq_len=16, global_batch=2)
    logs: list = []
    with tempfile.TemporaryDirectory() as d:
        sA, lossesA = train(m, opt, data, TrainLoopConfig(
            total_steps=6, ckpt_every=3, ckpt_dir=d, log_every=100), log=logs.append)
    with tempfile.TemporaryDirectory() as d2:
        _, first = train(m, opt, data, TrainLoopConfig(
            total_steps=3, ckpt_every=3, ckpt_dir=d2, log_every=100), log=logs.append)
        sB, rest = train(m, opt, data, TrainLoopConfig(
            total_steps=6, ckpt_every=3, ckpt_dir=d2, log_every=100), log=logs.append)
    assert "resumed from step 3" in logs
    assert first + rest == lossesA
    for (_, a), (_, b) in zip(named_leaves(sA), named_leaves(sB)):
        assert torch.equal(a, b)


def test_cli_trains_the_smoke_model_on_the_cpu(capsys):
    train_cli.main(["--smoke", "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert "smollm-135m-smoke" in out and "on cpu" in out and "loss " in out


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# kernel launches of one training step, on meta tensors
# ---------------------------------------------------------------------------

class _Calls:
    quiet = 0

    def __init__(self):
        self.calls = []

    def kernel(self, name, inputs):
        self.calls.append(name)


def _meta_step_calls(arch, B=8, S=128, **replace) -> list:
    """The kernel calls of one loss + backward at full width on ``meta``."""
    from repro_torch.models.registry import get_config
    m = get_model(get_config(arch).replace(dtype="float32", **replace), device="cpu")
    specs = m.param_specs()
    leaves = [t.requires_grad_(True) for _, t in named_leaves(specs)]
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32, device="meta"),
             "labels": torch.zeros((B, S), dtype=torch.int32, device="meta")}
    obs = _Calls()
    meta.add_observer(obs)
    try:
        loss = m.loss(specs, batch)
        torch.autograd.grad(loss, leaves)
    finally:
        meta.remove_observer(obs)
    return obs.calls


@pytest.mark.parametrize("remat", [True, False])
def test_smollm_training_step_launches_on_meta(remat):
    """smollm-135m (30 layers): one step launches 30 flash backward and
    2L + 1 = 61 rmsnorm backward kernels; the forward's 30 flash and 61
    rmsnorm launches are doubled by remat less the final norm, which
    remat does not recompute (60 and 121)."""
    calls = _meta_step_calls("smollm-135m", remat=remat)
    L = 30
    counts = {k: calls.count(k) for k in set(calls)}
    fwd = 2 if remat else 1
    assert counts == {"flash_attention": fwd * L, "rmsnorm": fwd * 2 * L + 1,
                      "flash_attention_bwd": L, "rmsnorm_bwd": 2 * L + 1}


@pytest.mark.parametrize("arch,layers", [("deepseek-v3-671b", 1), ("xlstm-1.3b", 8)])
def test_mla_and_xlstm_training_reach_only_rmsnorm_on_meta(arch, layers):
    """MLA (deepseek-v3) and xLSTM reach no attention kernel: their
    training step launches rmsnorm and its backward only (one backward
    per forward call; remat recomputes the checkpointed blocks'
    forward), so nothing on their training path lacks a backward kernel."""
    plain = _meta_step_calls(arch, B=1, S=128, n_layers=layers, remat=False)
    remat = _meta_step_calls(arch, B=1, S=128, n_layers=layers, remat=True)
    for calls in (plain, remat):
        assert set(calls) == {"rmsnorm", "rmsnorm_bwd"}
        assert calls.count("rmsnorm_bwd") == plain.count("rmsnorm")
    assert remat.count("rmsnorm") > plain.count("rmsnorm")
