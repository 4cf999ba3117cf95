"""Training under a sharding plan on the CPU, held against the JAX train
step on one device.

Two spawns of gloo ranks (``repro_torch.distributed.spawn``): tp = 2
(``ServingMesh(1, 2)``), and (data 2, model 2) with FSDP and under
``mode='fsdp2d'`` (four ranks).  For the smoke dense (llama3-8b), moe
(phi3.5-moe) and MLA (deepseek-v3) configs at 2 layers, and the smoke
zamba (4 Mamba2 blocks, the shared block used twice), xlstm (3 mLSTM
blocks and an sLSTM block) and whisper (2 + 2 layers, 24 frames) configs
at their smoke depths, in fp32, every rank starts from the JAX package's
state converted and cut to its piece (``convert.params_from_jax`` /
``opt_state_from_jax`` with ``plan=``):

  * the loss and every gradient leaf at the initial weights (the pieces
    put back together, ``sharding.assemble``) against
    ``jax.value_and_grad(Model.loss)`` on the global batch;
  * one JAX step (``make_train_step``), carried into the ranks, then two
    steps of each: the losses, the grad norms, and the parameters and
    moments after the third step (the factored second moment too);
  * the collectives per step at tp = 2, with remat off and on;
  * a run stopped and resumed from its per-rank checkpoints at (2, 2)
    equals the uninterrupted run bit for bit;
  * K/V heads shared by some but not all ranks: smoke chameleon (q / k
    norms) with 2 KV heads over tp = 4, on the four ranks of the grid
    spawn as one model axis, each head's projections' gradients summed
    over its two ranks (``sharding.sum_grad_kv``), against the JAX step;
    the sum skipped reads beyond the gradient tolerance;
  * heads the model axis does not divide (``sharding.head_split``):
    smoke smollm with smollm-135m's 9 query / 3 KV heads trained at tp =
    2 (6 / 2 and 3 / 1 per rank) and at tp = 4 on the grid's four ranks
    (2 / 1, 1 / 1, 3 / 1, 3 / 1: KV head 0 shared by ranks 0 and 1, its
    gradient summed over them), against the JAX step; and served at tp =
    4 on those ranks (``Model.prefill`` and the sequential ``Engine``
    under a serving plan of the four): greedy tokens equal to the JAX
    ``Engine``'s and the first logits within 1e-5 of the JAX prefill's;
  * one planted fault per trouble spot reads beyond the tolerance: the
    copy op's backward sum skipped at one layer, the moe gates' copy
    skipped (the router's gradient left partial), a replicated leaf
    counted tp times in the global norm; the split-row norm's backward
    sum skipped (zamba), Mamba2's B / C columns' gradient sum skipped
    (zamba), the mLSTM's ``x_inner`` columns' sum skipped (xlstm), and
    zamba's shared block taking the gradient of one of its two uses
    under FSDP.

Tolerances are ``tests/test_torch_train.py``'s (fp32; summation order
only): the loss within 1e-5 relative, each gradient leaf within 1e-4 of
its largest |value|, losses and moments within 1e-5, and the parameters
within 1e-5 wherever AdamW's step is well conditioned: at each of the
two carried steps the element's gradient, clipped, is at least 1e-3 of
its leaf's largest and 1e3 eps (the criterion of ``chip_smoke.py``'s
``train_parity``).  Elsewhere ``m / (sqrt(v) + eps)`` turns a gradient
difference of 1e-7 of the leaf's largest into a part of lr: the
one-process port reads 7e-4 from the JAX step there at smoke llama's
embedding, the same as under the plan.  The held share (67-81% of the
elements) is asserted above half.

The rank functions import no JAX (each rank process imports this
module).
"""

import functools
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.distributed import sharding, spawn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.utils import named_leaves  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest |value|
STATE_TOL = 1e-5
DENSE, PHI, DSV3 = "llama3-8b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"
CHAM = "chameleon-34b"                   # 2 KV heads over tp = 4 (tp4 cases)
SMOL = "smollm-135m"                    # 9 / 3 heads: uneven at tp 2 and 4
ZAMBA, XLSTM, WHISPER = "zamba2-2.7b", "xlstm-1.3b", "whisper-medium"
ARCHS = (DENSE, PHI, DSV3)
RECURRENT = (ZAMBA, XLSTM, WHISPER)      # and enc-dec
B, S = 4, 16
FRAMES = 24                             # whisper's encoder rows


def _smoke_kw(arch) -> dict:
    """The smoke depth: 2 layers for the decoder families; zamba, xlstm
    and whisper at their own smoke depths (two zamba units, one xLSTM
    unit, 2 + 2 whisper layers), as both packages' ``reduced`` give."""
    if arch == CHAM:
        return {"n_layers": 2, "n_kv_heads": 2}
    if arch == SMOL:
        return {"n_layers": 2, "n_heads": 9, "n_kv_heads": 3}
    return {} if arch in RECURRENT else {"n_layers": 2}


def _cfg(arch, **kw):
    return reduced(get_config(arch), **_smoke_kw(arch), **kw)


def _opt(factored: bool):
    return dict(lr=1e-3, warmup_steps=2, factored=factored,
                min_factored_size=16)


def _batches(cfg, n: int = 3) -> list:
    out = []
    for s in range(n):
        rng = np.random.default_rng(s)
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        if cfg.is_encdec:
            out[-1]["frames"] = (rng.standard_normal((B, FRAMES, cfg.d_model))
                                 * 0.1).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# what every rank runs (no JAX here)
# ---------------------------------------------------------------------------

def _pieces(plan, tree, ragged: bool = False) -> dict:
    """Every rank's piece of every leaf, on every rank (grid order);
    ``ragged``: pieces of other shapes on other ranks (heads split
    unevenly), sent flat and padded to the largest."""
    import torch.distributed as dist
    out = {}
    n = plan.mesh.size
    for path, t in named_leaves(tree):
        t = t.contiguous()
        if not ragged:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=plan.world_group)
            out[path] = parts
            continue
        shapes = [None] * n
        dist.all_gather_object(shapes, tuple(t.shape), group=plan.world_group)
        size = max(int(np.prod(s)) for s in shapes)
        flat = torch.zeros(size, dtype=t.dtype)
        flat[:t.numel()] = t.reshape(-1)
        parts = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(parts, flat, group=plan.world_group)
        out[path] = [p[:int(np.prod(s))].reshape(s)
                     for p, s in zip(parts, shapes)]
    return out


def _whole(plan, cfg, tree, specs=None) -> dict:
    """The whole leaves of a tree of pieces (numpy)."""
    specs = specs or dict(named_leaves(sharding.plan_param_specs(cfg, plan)))
    ragged = plan.tp > 1 and not sharding.head_split(cfg, plan.tp).even
    return {p: sharding.assemble(v, specs[p], plan).numpy()
            for p, v in _pieces(plan, tree, ragged).items()}


def _grads(model, params, batch):
    from repro_torch.train.train_loop import shard_rows
    plan = model.plan
    leaves = [t for _, t in named_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    sharding.reset_collective_stats()
    loss = model.loss(params, shard_rows(batch, plan.data_rank, plan.data))
    grads = torch.autograd.grad(loss, leaves)
    calls = sharding.collective_stats()["calls"]
    for t in leaves:
        t.requires_grad_(False)
    model.layout.end_step()
    from repro_torch.distributed import fsdp
    loss = float(fsdp.batch_mean(loss.detach(), model.layout))
    named = dict(zip((n for n, _ in named_leaves(params)), grads))
    return loss, named, calls


def _case(group, plan, arch, jax_state: dict, factored: bool,
          remat: bool = False, plant=None) -> dict:
    from repro_torch.train.train_loop import make_train_step
    cfg = _cfg(arch, remat=remat)
    model = get_model(cfg, device="cpu", plan=plan)
    out = {}
    with plant(model) if plant else _nothing():
        init = convert.params_from_jax(jax_state["init"], cfg, "cpu", plan)
        batches = _batches(cfg)
        loss, grads, calls = _grads(model, init, batches[0])
        out["loss0"], out["grads"] = loss, _whole(plan, cfg, grads)
        out["calls_grad"] = calls
        opt_cfg = topt.OptimizerConfig(**_opt(factored))
        step = make_train_step(model, opt_cfg)
        state = {"params": convert.params_from_jax(
                     jax_state["params"], cfg, "cpu", plan),
                 "opt": convert.opt_state_from_jax(
                     jax_state["opt"], cfg, "cpu", plan)}
        out["losses"], out["gnorms"], out["calls_step"] = [], [], []
        for b in batches[1:]:
            sharding.reset_collective_stats()
            state, met = step(state, b)
            out["calls_step"].append(sharding.collective_stats()["kinds"])
            out["losses"].append(float(met["loss"]))
            out["gnorms"].append(float(met["grad_norm"]))
    out["params"] = _whole(plan, cfg, state["params"])
    specs = sharding.opt_state_specs(sharding.plan_param_specs(cfg, plan),
                                     plan.mesh, opt_state=state["opt"])
    out["m"] = _whole(plan, cfg, state["opt"]["m"],
                      dict(named_leaves(specs["m"])))
    out["v"] = _whole(plan, cfg, state["opt"]["v"],
                      dict(named_leaves(specs["v"])))
    return out


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _skip_copy:
    """Trouble spot 3: the first copy op of the forward (layer 0's q / k /
    v input) sums nothing backward."""

    def __init__(self, model):
        self.calls = 0

    def __enter__(self):
        self.real = sharding.copy_to_model

        def copy(x):
            self.calls += 1
            return x if self.calls == 1 else self.real(x)
        sharding.copy_to_model = copy
        return self

    def __exit__(self, *exc):
        sharding.copy_to_model = self.real
        return False


class _partial_router:
    """Trouble spot 5: the moe gates enter the rank's experts without the
    copy op, so the router's gradient stays a partial."""

    def __init__(self, model):
        self.top_k = model.cfg.top_k

    def __enter__(self):
        self.real = sharding.copy_to_model
        k = self.top_k
        sharding.copy_to_model = lambda x: (
            x if x.dim() == 2 and x.shape[-1] == k else self.real(x))
        return self

    def __exit__(self, *exc):
        sharding.copy_to_model = self.real
        return False


class _norm_counts_copies:
    """The global norm counts a replicated leaf once per rank."""

    def __init__(self, model):
        self.layout = model.layout

    def __enter__(self):
        self.layout.copies = lambda path: 1
        return self

    def __exit__(self, *exc):
        del self.layout.copies
        return False


class _split_norm_partial:
    """The split-row norm's backward sum skipped: each norm's second
    reduce (its backward dots) returns the rank's own."""

    def __init__(self, model):
        pass

    def __enter__(self):
        self.real = sharding.rank_sum

        def rank_sum(plan):
            reduce, calls = self.real(plan), [0]

            def once(buf):
                calls[0] += 1
                return reduce(buf) if calls[0] == 1 else buf
            return once
        sharding.rank_sum = rank_sum
        return self

    def __exit__(self, *exc):
        sharding.rank_sum = self.real
        return False


class _columns_partial:
    """A replicated weight's columns keep the rank's partial gradient:
    Mamba2's B / C columns (zamba) or the mLSTM's ``x_inner`` columns and
    conv (xlstm), whichever the model has."""

    def __init__(self, model):
        pass

    def __enter__(self):
        self.real = sharding.sum_grad_columns
        sharding.sum_grad_columns = lambda w, *a, **k: w
        return self

    def __exit__(self, *exc):
        sharding.sum_grad_columns = self.real
        return False


class _shared_block_once:
    """zamba's shared block takes the gradient of its first use only (the
    later units read it detached)."""

    def __init__(self, model):
        pass

    def __enter__(self):
        from repro_torch.models import transformer
        self.mod, self.real = transformer, transformer.zamba_unit
        real = self.real

        def unit(mamba_params, shared_params, x, cfg, positions, cache, u,
                 *rest):
            if u > 0:
                tree = shared_params()
                detached = {k: ({n: t.detach() for n, t in v.items()}
                                if isinstance(v, dict) else v.detach())
                            for k, v in tree.items()}
                shared_params = lambda: detached  # noqa: E731
            return real(mamba_params, shared_params, x, cfg, positions, cache,
                        u, *rest)
        transformer.zamba_unit = unit
        return self

    def __exit__(self, *exc):
        self.mod.zamba_unit = self.real
        return False


class _kv_sum_skipped:
    """A shared KV head's projections keep each rank's partial gradient
    (the subgroup sum skipped)."""

    def __init__(self, model):
        pass

    def __enter__(self):
        self.real = sharding.sum_grad_kv
        sharding.sum_grad_kv = lambda w: w
        return self

    def __exit__(self, *exc):
        sharding.sum_grad_kv = self.real
        return False


PLANTS = {"skip_copy": _skip_copy, "partial_router": _partial_router,
          "kv_sum": _kv_sum_skipped,
          "norm_copies": _norm_counts_copies,
          "split_norm_sum": _split_norm_partial, "bc_sum": _columns_partial,
          "x_inner_sum": _columns_partial, "shared_once": _shared_block_once}


def _resume(plan, arch: str, root: str) -> dict:
    """``train()`` for 4 steps, and 2 + 2 resumed from the per-rank
    checkpoints: the pieces, bit for bit."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.train_loop import TrainLoopConfig, train
    cfg = _cfg(arch)
    model = get_model(cfg, device="cpu", plan=plan)
    opt_cfg = topt.OptimizerConfig(**_opt(False))
    data = DataConfig(cfg.vocab_size, S, B, seed=3)
    whole, losses = train(model, opt_cfg, data, TrainLoopConfig(
        total_steps=4, ckpt_every=100, log_every=100), log=lambda _: None)
    ckpt = os.path.join(root, "ckpt")
    train(model, opt_cfg, data, TrainLoopConfig(
        total_steps=2, ckpt_every=2, ckpt_dir=ckpt, log_every=100),
        log=lambda _: None)
    resumed, rest = train(model, opt_cfg, data, TrainLoopConfig(
        total_steps=4, ckpt_every=2, ckpt_dir=ckpt, log_every=100),
        log=lambda _: None)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        named_leaves(whole), named_leaves(resumed)))
    return {"same": same, "losses": losses, "rest": rest,
            "dirs": sorted(os.listdir(ckpt))}


SERVE_NEW = 5


def _serve4(group, arch: str, jax_params: dict) -> dict:
    """The grid's four ranks as one serving model axis (SPMD, every rank
    alike): the first prefill's logits and the sequential ``Engine``'s
    greedy tokens of two prompts under the plan."""
    from repro_torch.runtime.engine import Engine
    plan = sharding.ShardingPlan(mesh=sharding.ServingMesh(1, 4),
                                 rank=group.global_rank,
                                 group=group.world_group)
    cfg = _cfg(arch)
    model = get_model(cfg, device="cpu", plan=plan)
    params = convert.params_from_jax(jax_params, cfg, device="cpu", plan=plan)
    prompts = _serve_prompts(cfg)
    logits, _ = model.prefill(params, {"tokens": prompts[:1]},
                              model.make_cache(1, S + SERVE_NEW))
    tokens = Engine(model, params).generate(prompts, SERVE_NEW,
                                            cache_len=S + SERVE_NEW).tokens
    return {"logits": logits.numpy(), "tokens": tokens,
            "heads": (model.local_cfg.n_heads, model.local_cfg.n_kv_heads)}


def _serve_prompts(cfg) -> np.ndarray:
    return np.random.default_rng(9).integers(
        1, cfg.vocab_size, (2, S)).astype(np.int32)


def _ranks(group, cases: list, jax_states: dict, root: str) -> dict:
    out = {}
    for key in cases:
        kind, arch, mode, fsdp, factored, remat, plant = key
        plan = group.training_plan(fsdp=fsdp, mode=mode)
        if kind == "serve4":
            out[key] = _serve4(group, arch,
                               jax_states[(arch, factored)]["init"])
            continue
        if kind == "tp4":
            # the grid's four ranks as one model axis
            plan = sharding.training_plan(
                sharding.ServingMesh(1, 4), rank=group.global_rank,
                group=group.world_group, world_group=group.world_group)
        if kind == "resume":
            out[key] = _resume(plan, arch, root)
            continue
        out[key] = _case(group, plan, arch, jax_states[(arch, factored)],
                         factored, remat, PLANTS.get(plant))
    return out if group.global_rank == 0 else None


# ---------------------------------------------------------------------------
# the JAX side and the tests
# ---------------------------------------------------------------------------

def _key(kind="step", arch=DENSE, mode="tp", fsdp=False, factored=False,
         remat=False, plant=None):
    return (kind, arch, mode, fsdp, factored, remat, plant)


# the recurrent and enc-dec families' trouble spots (RECURRENT_PLANTS)
RECURRENT_PLANTS = (_key(arch=ZAMBA, plant="split_norm_sum"),
                    _key(arch=ZAMBA, plant="bc_sum"),
                    _key(arch=XLSTM, plant="x_inner_sum"),
                    _key(arch=ZAMBA, fsdp=True, plant="shared_once"))
TP_CASES = ([_key(arch=a) for a in ARCHS + RECURRENT] + [_key(arch=SMOL)]
            + [_key(factored=True), _key(arch=ZAMBA, factored=True),
               _key(remat=True),
               _key(plant="skip_copy"), _key(arch=PHI, plant="partial_router"),
               _key(plant="norm_copies")]
            + [k for k in RECURRENT_PLANTS if not k[3]])
GRID_CASES = ([_key(arch=a, fsdp=True) for a in ARCHS + RECURRENT]
              + [_key(arch=a, mode="fsdp2d") for a in ARCHS + RECURRENT]
              + [_key(fsdp=True, factored=True),
                 _key(kind="resume", fsdp=True)]
              + [k for k in RECURRENT_PLANTS if k[3]]
              + [_key(kind="tp4", arch=CHAM),
                 _key(kind="tp4", arch=CHAM, plant="kv_sum"),
                 _key(kind="tp4", arch=SMOL), _key(kind="serve4", arch=SMOL)])


@functools.lru_cache(maxsize=None)
def _jax_model(arch: str) -> tuple:
    """The JAX smoke model, its weights and its jitted loss gradient."""
    import jax
    from repro.models.registry import get_smoke_model as jax_smoke
    jm = jax_smoke(arch, **_smoke_kw(arch))
    return jm, jm.init_params(jax.random.PRNGKey(0)), jax.jit(
        jax.value_and_grad(jm.loss))


def _jax_state(arch: str, factored: bool) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.train import optimizer as jopt
    from repro.train.train_loop import make_train_step as jax_train_step
    jm, jp, vg = _jax_model(arch)
    cfg = jopt.OptimizerConfig(**_opt(factored))
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _batches(jm.cfg)]
    loss0, grads = vg(jp, batches[0])
    jstep = jax.jit(jax_train_step(jm, cfg))
    state = {"params": jp, "opt": jopt.init_opt_state(jp, cfg)}
    state, _ = jstep(state, batches[0])
    np_state = jax.tree.map(np.asarray, state)
    losses, gnorms, held = [], [], None
    for b in batches[1:]:
        g = jax.tree.map(np.asarray, vg(state["params"], b)[1])
        state, met = jstep(state, b)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        clip = min(1.0, cfg.clip_norm / gnorms[-1])
        ok = jax.tree.map(
            lambda x: np.abs(x) * clip >= max(1e-3 * np.abs(x).max() * clip,
                                              1e3 * cfg.eps), g)
        held = ok if held is None else jax.tree.map(np.logical_and, held, ok)
    return {"init": jax.tree.map(np.asarray, jp), "params": np_state["params"],
            "opt": np_state["opt"], "loss0": float(loss0),
            "grads": jax.tree.map(np.asarray, grads), "losses": losses,
            "gnorms": gnorms, "final": jax.tree.map(np.asarray, state),
            "held": held}


@pytest.fixture(scope="module")
def jax_states():
    return {(a, f): _jax_state(a, f)
            for a, f in {(k[1], k[4]) for k in TP_CASES + GRID_CASES
                         if k[0] in ("step", "tp4")}}


@pytest.fixture(scope="module")
def runs(jax_states):
    ranks_in = {k: {n: v[n] for n in ("init", "params", "opt")}
                for k, v in jax_states.items()}
    with tempfile.TemporaryDirectory() as root:
        tp = spawn(_ranks, 2, (TP_CASES, ranks_in, root), device="cpu",
                   timeout_s=600, collective_timeout_s=120)
        grid = spawn(_ranks, 2, (GRID_CASES, ranks_in, root), data=2,
                     device="cpu", timeout_s=600, collective_timeout_s=120)
    return {**tp, **grid}


def _want(jax_state, arch, what: str) -> dict:
    cfg = _cfg(arch)
    if what in ("m", "v"):
        tree = convert.opt_state_from_jax(jax_state["final"]["opt"], cfg,
                                          "cpu")[what]
    else:
        tree = convert.params_from_jax(jax_state[what] if what != "params"
                                       else jax_state["final"]["params"],
                                       cfg, "cpu")
    return {n: t.numpy() for n, t in named_leaves(tree)}


def _grad_errors(got: dict, want: dict) -> dict:
    assert set(got) == set(want)
    return {n: float(np.abs(got[n] - want[n]).max())
            / max(float(np.abs(want[n]).max()), 1e-30) for n in want}


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=STATE_TOL,
                               rtol=STATE_TOL, err_msg=what)


STEP_CASES = [k for k in TP_CASES + GRID_CASES
              if k[0] == "step" and k[6] is None]


@pytest.mark.parametrize("key", STEP_CASES, ids=lambda k: "-".join(
    str(x) for x in k[1:6]))
def test_train_step_under_a_plan_matches_jax(runs, jax_states, key):
    """Loss and every gradient at the initial weights, then two steps from
    the JAX state after one: losses, grad norms, parameters and moments."""
    _check_step(runs, jax_states, key)


def test_shared_kv_heads_train_at_tp4_against_jax(runs, jax_states):
    """2 KV heads over 4 ranks (each head on two of them): the step held
    as above; the planted control, each rank's K/V projection gradients
    left partial, moves ``wk`` / ``wv`` past the gradient tolerance."""
    _check_step(runs, jax_states, _key(kind="tp4", arch=CHAM))
    errs = _grad_errors(runs[_key(kind="tp4", arch=CHAM, plant="kv_sum")]
                        ["grads"], _want(jax_states[(CHAM, False)], CHAM,
                                         "grads"))
    assert max(v for n, v in errs.items()
               if n.endswith(("wk", "wv"))) > GRAD_TOL


def test_uneven_heads_train_at_tp4_against_jax(runs, jax_states):
    """9 query / 3 KV heads over 4 ranks (2 / 1, 1 / 1, 3 / 1, 3 / 1):
    KV head 0 on ranks 0 and 1, its projections' gradients summed over
    the two; the step held as above (tp = 2, 6 / 2 and 3 / 1, is a case
    of ``test_train_step_under_a_plan_matches_jax``)."""
    _check_step(runs, jax_states, _key(kind="tp4", arch=SMOL))


def test_uneven_heads_serve_at_tp4_against_jax(runs):
    """Served on the four ranks: rank 0's heads, the first logits within
    1e-5 of the JAX prefill's largest |logit|, and the ``Engine``'s
    greedy tokens equal to the JAX ``Engine``'s."""
    import jax.numpy as jnp
    from repro.runtime.engine import Engine
    jm, jp, _ = _jax_model(SMOL)
    got = runs[_key(kind="serve4", arch=SMOL)]
    assert got["heads"] == (2, 1)
    prompts = _serve_prompts(jm.cfg)
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompts[:1])},
                         jm.make_cache(1, S + SERVE_NEW))
    want = np.asarray(want)
    assert np.abs(got["logits"] - want).max() <= 1e-5 * np.abs(want).max()
    tokens = Engine(jm, jp).generate(prompts, SERVE_NEW,
                                     cache_len=S + SERVE_NEW).tokens
    np.testing.assert_array_equal(got["tokens"], np.asarray(tokens))


def _check_step(runs, jax_states, key):
    _, arch, *_ = key
    factored = key[4]
    js, got = jax_states[(arch, factored)], runs[key]
    assert abs(got["loss0"] - js["loss0"]) <= LOSS_RTOL * abs(js["loss0"])
    errs = _grad_errors(got["grads"], _want(js, arch, "grads"))
    assert max(errs.values()) <= GRAD_TOL, max(errs.items(), key=lambda e: e[1])
    for g, w in zip(got["losses"], js["losses"]):
        assert abs(g - w) <= STATE_TOL
    _close(got["gnorms"], js["gnorms"], "grad_norm")
    for what in ("m", "v"):
        want = _want(js, arch, what)
        assert set(got[what]) == set(want)
        for n in want:
            _close(got[what][n], want[n], f"{what}.{n}")
    want, held = _want(js, arch, "params"), _want(js, arch, "held")
    assert set(got["params"]) == set(want)
    for n in want:
        _close(got["params"][n][held[n]], want[n][held[n]], f"params.{n}")
    share = (sum(int(h.sum()) for h in held.values())
             / sum(h.size for h in held.values()))
    assert share > 0.5, share


def test_factored_moments_are_held_under_fsdp(runs):
    """The factored second moment keeps its rows and columns per piece:
    at (2, 2) with FSDP they equal the JAX state's (the step test above),
    and some leaves are factored at all."""
    got = runs[_key(fsdp=True, factored=True)]["v"]
    assert any(n.endswith(".row") for n in got)


def test_collectives_per_step_at_tp2(runs):
    """Smoke llama at 2 layers, one KV head (kept by both ranks), a
    vocab-parallel head.  Forward: the embedding's sum, attention and MLP
    sums per layer (2L), the loss's max and its [2, B, S] sum (2).
    Backward: the copy ops' sums, per layer q / k / v input, k, v and the
    MLP input (4L, since k and v enter the rank's heads after the rope),
    and the head's input (1).  The optimizer: the global norm (1).  Remat
    recomputes each layer's attention sum (L): the recomputation stops at
    the last tensor the layer's backward reads (PyTorch's early stop), and
    nothing in the block reads its MLP's sum."""
    L = 2
    fwd, bwd, opt = 1 + 2 * L + 2, 4 * L + 1, 1
    plain = runs[_key()]
    assert plain["calls_grad"] == fwd + bwd
    assert plain["calls_step"] == [{"all_reduce": fwd + bwd + opt}] * 2
    remat = runs[_key(remat=True)]
    assert remat["calls_step"] == [{"all_reduce": fwd + bwd + opt + L}] * 2


def test_collectives_per_step_at_2x2_fsdp(runs):
    """(data 2, model 2), FSDP: the tp = 2 step's sums, then per leaf cut
    over 'data' one all_gather forward, one more when the backward first
    reads it (every leaf is saved by the op that reads it), and one
    reduce_scatter of its gradient; a leaf whole over 'data' (none of
    smoke llama's: every leaf has a dimension 'data' divides) would take
    one all_reduce; the loss metric's mean is one more all_reduce."""
    L, n_leaves = 2, 3 + 9 * 2
    got = runs[_key(fsdp=True)]["calls_step"]
    fwd, bwd, opt = 1 + 2 * L + 2, 4 * L + 1, 1
    assert got == [{"all_reduce": fwd + bwd + opt + 1,
                    "all_gather": 2 * n_leaves,
                    "reduce_scatter": n_leaves}] * 2


def test_resume_equals_uninterrupted_at_2x2(runs):
    out = runs[_key(kind="resume", fsdp=True)]
    assert out["same"]
    assert out["losses"][2:] == out["rest"]
    assert out["dirs"] == ["rank0", "rank1", "rank2", "rank3"]


def test_planted_faults_exceed_the_tolerance(runs, jax_states):
    """Each trouble spot planted reads beyond the tolerance the sound runs
    hold: the skipped copy moves a gradient past 1e-4 of its leaf's
    largest, the partial router its router's, and the replicated leaves
    counted per rank move the grad norm past 1e-5."""
    js = jax_states[(DENSE, False)]
    errs = _grad_errors(runs[_key(plant="skip_copy")]["grads"],
                        _want(js, DENSE, "grads"))
    assert max(errs.values()) > GRAD_TOL
    errs = _grad_errors(runs[_key(arch=PHI, plant="partial_router")]["grads"],
                        _want(jax_states[(PHI, False)], PHI, "grads"))
    assert max(v for n, v in errs.items() if n.endswith("router")) > GRAD_TOL
    got = runs[_key(plant="norm_copies")]["gnorms"]
    assert max(abs(g - w) / w for g, w in zip(got, js["gnorms"])) > STATE_TOL


def test_seq_parallel_and_shared_kv_training_name_their_items():
    """A seq-parallel batch's specs place (the sequence over 'model'), its
    train step raises naming item 10, and so does a loss through a fused
    ``wqkv`` whose one KV head every rank shares (what is left of training
    under a plan; shared heads unfused and the recurrent and enc-dec
    families train, the tests above)."""
    from repro_torch.distributed.sharding import ServingMesh
    mesh = ServingMesh(2, 2)
    batch = {"tokens": np.zeros((4, 8), np.int32)}
    assert sharding.batch_specs(batch, mesh, seq_parallel=True) == {
        "tokens": sharding.P("data", "model")}
    from repro_torch.train.train_loop import make_train_step
    plan = sharding.training_plan(mesh, fsdp=True, mode="fsdp2d")
    model = get_model(_cfg(DENSE), device="cpu", plan=plan)
    with pytest.raises(NotImplementedError, match="item 10"):
        make_train_step(model, topt.OptimizerConfig(), seq_parallel=True)
    # one KV head over four ranks through a fused wqkv: its gradient cannot
    # be summed apart from q's (two heads over four ranks train, above)
    shared = get_model(_cfg(DENSE, fused_qkv=True), device="cpu",
                       plan=sharding.training_plan(ServingMesh(1, 4)))
    with pytest.raises(NotImplementedError, match="item 10"):
        shared.loss(shared.init_params(), {
            "tokens": np.zeros((1, 4), np.int32),
            "labels": np.zeros((1, 4), np.int32)})


# the recurrent and enc-dec families' collectives of one step at tp = 2,
# per kind (smoke shapes: vocabulary 256, every model vocab-parallel)
def _recurrent_collectives(arch) -> int:
    """all_reduces of one tp = 2 step without remat: zamba (L Mamba2
    blocks, U uses of the shared block) forward 1 + 2L + 2U + 2 (the
    embedding, each block's split-norm sums and out-projection, each
    use's attention and MLP sums, the loss's max and sums), backward
    4L + 2U + 1 (each block's input copy, B / C columns of ``in_proj``
    and ``conv_w``, the split norm's dots; each use's two copies; the
    head); xlstm (M mLSTM, U sLSTM blocks, the post-MLP whole) forward
    1 + 2M + 2U + 2, backward 4M + 2U + 1 (the mLSTM's ``x_inner``
    columns and conv in place of B / C; the sLSTM's input copy and split
    norm); whisper (L + Ld layers) forward 2L + 3Ld + 1 + 2 (the
    embedding's sum, the loss), backward 2L + 4Ld + 1 (ln1's and the MLP
    input's copies per layer, and per decoder layer the cross
    attention's query and encoder-output copies); the optimizer's norm 1."""
    cfg = _cfg(arch)
    if arch == ZAMBA:
        from repro_torch.models.transformer import n_units
        L, U = cfg.n_layers, n_units(cfg)
        return (1 + 2 * L + 2 * U + 2) + (4 * L + 2 * U + 1) + 1
    if arch == XLSTM:
        from repro_torch.models.transformer import xlstm_units
        U, per = xlstm_units(cfg)
        M = U * per
        return (1 + 2 * M + 2 * U + 2) + (4 * M + 2 * U + 1) + 1
    L, Ld = cfg.n_layers, cfg.dec_layers
    return (2 * L + 3 * Ld + 3) + (2 * L + 4 * Ld + 1) + 1


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_and_encdec_collectives_per_step_at_tp2(runs, arch):
    """Each carried step at tp = 2 runs the reckoned all_reduces and no
    other collective; the gradient read alone runs them less the
    optimizer's."""
    got = runs[_key(arch=arch)]
    want = _recurrent_collectives(arch)
    assert got["calls_step"] == [{"all_reduce": want}] * 2
    assert got["calls_grad"] == want - 1


@pytest.mark.parametrize("key", RECURRENT_PLANTS, ids=lambda k: k[6])
def test_recurrent_and_encdec_planted_faults_exceed_the_tolerance(
        runs, jax_states, key):
    """Each new trouble spot planted moves some gradient leaf past 1e-4 of
    its largest: the split norm's backward sum, Mamba2's B / C columns'
    sum, the mLSTM's ``x_inner`` columns' sum, and the shared block's
    later uses (under FSDP) — while the sound runs above hold."""
    arch = key[1]
    errs = _grad_errors(runs[key]["grads"],
                        _want(jax_states[(arch, False)], arch, "grads"))
    assert max(errs.values()) > GRAD_TOL, max(errs.items(), key=lambda e: e[1])
