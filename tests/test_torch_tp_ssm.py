"""zamba and xLSTM under tensor parallelism on the CPU: two gloo ranks
against the JAX package on one device.

One spawn of two ranks per module (``repro_torch.distributed.spawn``,
gloo, the divergence guard on) serves three smoke models in fp32, each
with the JAX package's weights converted per rank
(``convert.params_from_jax(..., plan=)``):

  * ``zamba``: zamba2 (4 Mamba2 blocks, 2 units of the shared attention
    block), 2 of its 4 Mamba2 heads and 2 of its 4 attention heads per
    rank, B and C whole;
  * ``xlstm``: xlstm (3 mLSTM blocks and 1 sLSTM block) at ``d_model``
    64, whose sLSTM post-MLP width 85 does not split: every rank runs
    all of it;
  * ``xlstm-split``: the same at ``d_model`` 96, whose post-MLP width 128
    splits over the ranks.

The checks, each its own test:

  * ``FaaSRuntime(mesh=ServingMesh(1, 2))`` serves cold, fork (streamed
    prefill while the weights are in flight) and warm over the dense slot
    pool: greedy tokens equal ``repro.runtime.engine.Engine``'s on one
    device;
  * the first prefill's logits within 1e-5 of the largest |logit| of the
    JAX prefill's, and the sequential ``Engine`` under the plan against
    the JAX ``Engine``;
  * the collectives of one prefill and one decode call: zamba 2L + 2U + 2
    (per Mamba2 block the split norm's sums and ``out_proj``; per unit the
    shared block's attention and MLP; the embedding and the head), xLSTM
    2M + 2U + 2 with the post-MLP replicated and 2M + 3U + 2 with it split
    (per mLSTM block the split norm and ``down_proj``; per sLSTM block the
    split norm, the gather of its heads and the split MLP);
  * the kernels' launches per call: the split-row norm twice per split
    row, the whole-row norm elsewhere;
  * fork bytes per rank sum to the one-device fork's plus what every rank
    holds alike once more (replicated leaves and the whole parts of
    Mamba2's ``in_proj`` / ``conv_w`` and the mLSTM's ``up_proj``);
  * the dense pool's host state identical on both ranks and equal to the
    JAX pool's, and each rank's state arena cut as ``cache_specs`` says;
  * the serve CLI with ``--tp 2`` for both architectures and
    ``--lora --tp 2`` on zamba;
  * whisper (enc-dec; 2 + 2 layers, 4 heads) under the serving plan, 2
    of its heads per rank in the encoder, the decoder's self-attention
    and its cross-attention: a prefill of two sequences of 24 frames
    through ``Model.prefill`` and greedy decode steps through
    ``Model.decode_step``, every step's logits within 1e-5 of the largest
    |logit| of the JAX ``prefill`` / ``decode_step``'s and the tokens
    equal; the sequential ``Engine`` refuses the plan, as the
    reference's takes none.

The plain split-row norm itself is held against the whole-row norm here
too, and a slice normalised alone against it (it differs).  The rank
functions below import no JAX (each rank process imports this module).
``test_torch_tp_specs.py`` holds the specs against JAX's.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tidal  # noqa: E402
from repro_torch.distributed import sharding, spawn  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.utils import named_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MAX_LEN, NEW = 32, 5
ZAMBA, XLSTM = "zamba2-2.7b", "xlstm-1.3b"
# case -> (architecture, config overrides, weight seed)
CASES = {"zamba": (ZAMBA, {}, 1), "xlstm": (XLSTM, {}, 2),
         "xlstm-split": (XLSTM, {"d_model": 96}, 3)}
# fp32 logits: the ranks' partial sums meet in a different order than one
# device's products, so they agree to this share of the largest |logit|
LOGIT_TOL = 1e-5


def _cfg(case: str):
    arch, extra, _ = CASES[case]
    return reduced(get_config(arch), **extra)


def _expected_collectives(cfg) -> int:
    """Collectives of one model call at tp = 2 (see the module doc)."""
    if cfg.family == "zamba":
        return 2 * cfg.n_layers + 2 * transformer.n_units(cfg) + 2
    units, m_per = transformer.xlstm_units(cfg)
    per_slstm = 3 if sharding.slstm_mlp_split(cfg, 2) else 2
    return 2 * units * m_per + per_slstm * units + 2


def _workload():
    rng = np.random.default_rng(5)
    p0 = rng.integers(1, 256, 9).astype(np.int32)
    p1 = rng.integers(1, 256, 11).astype(np.int32)
    return [("cold", p0), ("fork", p1), ("warm", p0)]


def _batch():
    p0 = _workload()[0][1]
    return np.stack([p0, p0[::-1]])


# ---------------------------------------------------------------------------
# what every rank runs (no JAX here)
# ---------------------------------------------------------------------------

def _faas_pass(group, fn, reqs) -> dict:
    from repro_torch.runtime import FaaSRuntime
    from repro_torch.runtime.gateway import InvocationRequest
    rt = FaaSRuntime(mesh=group.mesh, device="cpu", n_slots=2,
                     max_len=MAX_LEN, trace_seq=8)
    rt.deploy(fn, {}, prewarm_seq=8)
    out = []
    for kind, prompt in reqs:
        if kind == "fork":
            rt.evict(fn.name)
        res = rt.submit(InvocationRequest(fn.name, prompt,
                                          max_new_tokens=NEW)).result()
        row = {"kind": res.kind, "tokens": res.tokens.tolist(),
               "streamed": res.streamed_prefill}
        if res.fork_stats is not None:
            row["fork"] = [(s.streamed_bytes, s.reused_bytes,
                            s.replicated_bytes)
                           for s in res.fork_stats.per_rank]
        out.append(row)
    rt.evict()
    return out


def _collectives(call) -> int:
    sharding.reset_collective_stats()
    call()
    return sharding.collective_stats()["calls"]


class _KernelNames:
    """The kernels a call on ``meta`` tensors reaches, by name (the plain
    versions on the CPU count no launch)."""
    quiet = 0

    def __init__(self):
        self.calls = {}

    def kernel(self, name, inputs):
        self.calls[name] = self.calls.get(name, 0) + 1


def _pool_state(pool) -> tuple:
    return [list(pool._free), pool.n_free]


def _arena_shapes(pool) -> dict:
    return {k: tuple(t.shape) for k, t in named_leaves(pool.cache)}


def _pool_ops(group, model) -> dict:
    """A fixed operation sequence on a dense slot pool, the state on every
    rank."""
    from repro_torch.runtime.kv_pool import KVCachePool
    pool = KVCachePool(model, 3, MAX_LEN, plan=group.plan)
    s0 = pool.alloc()
    s1 = pool.alloc()
    pool.write_slot(s1, model.make_cache(1, MAX_LEN))
    pool.release(s0)
    s2 = pool.alloc()
    return {"slots": [s0, s1, s2],
            "states": group.gather(_pool_state, pool),
            "arenas": group.gather(_arena_shapes, pool)}


WHISPER = "whisper-medium"
WHISPER_FRAMES, WHISPER_STEPS = 24, 3


def _whisper_inputs(cfg) -> tuple:
    rng = np.random.default_rng(11)
    frames = (rng.standard_normal((2, WHISPER_FRAMES, cfg.d_model))
              * 0.1).astype(np.float32)
    return frames, rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)


def _whisper(model, params) -> dict:
    """On the controller: the prefill, then greedy decode steps, through
    the model's mirrored calls (every rank runs its heads)."""
    frames, toks = _whisper_inputs(model.cfg)
    cache = model.make_cache(2, WHISPER_FRAMES)
    logits, cache = model.prefill(params, {"frames": frames, "tokens": toks},
                                  cache)
    steps, tokens = [logits.numpy()], [logits.argmax(-1)]
    for i in range(WHISPER_STEPS):
        logits, cache = model.decode_step(
            params, cache, {"tokens": tokens[-1][:, None].numpy()},
            toks.shape[1] + i)
        steps.append(logits.numpy())
        tokens.append(logits.argmax(-1))
    from repro_torch.runtime.engine import Engine
    try:
        Engine(model, params)
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    return {"logits": np.stack(steps), "refused": refused,
            "tokens": torch.stack(tokens, 1).numpy(),
            "heads": model.local_cfg.n_heads}


def _ranks(group, jax_params: dict, whisper_params: dict) -> dict:
    """Every scenario, on every rank: the workers serve, the controller
    drives and returns what the tests check."""
    reqs = _workload()
    wcfg = reduced(get_config(WHISPER))
    whisper = get_model(wcfg, device="cpu", plan=group.plan)
    wparams = group.bind(convert.params_from_jax(
        whisper_params, wcfg, device="cpu", plan=group.plan))
    models, fns, params = {}, {}, {}
    for case in CASES:
        cfg = _cfg(case)
        models[case] = get_model(cfg, device="cpu", plan=group.plan)
        params[case] = group.bind(convert.params_from_jax(
            jax_params[case], cfg, device="cpu", plan=group.plan))
        fns[case] = group.bind(tidal.static_function(case, models[case],
                                                     params[case]))
    if not group.is_controller:
        group.serve()
        return None
    from repro_torch.runtime.engine import Engine
    out = {}
    for case in CASES:
        m, p = models[case], params[case]
        r = {"faas": _faas_pass(group, fns[case], reqs)}
        cache = m.make_cache(1, MAX_LEN)
        prompt = reqs[0][1][None]
        got = {}
        r["prefill_collectives"] = _collectives(lambda: got.update(
            logits=m.prefill(p, {"tokens": prompt}, cache)[0]))
        r["logits"] = got["logits"].numpy()
        r["decode_collectives"] = _collectives(lambda: m.decode_step(
            p, cache, {"tokens": np.ones((1, 1), np.int32)}, prompt.shape[1]))
        r["engine"] = Engine(m, p).generate(_batch(), NEW,
                                            cache_len=MAX_LEN).tokens
        local = m.local_cfg
        r["local"] = {"heads": local.n_heads, "ssm_heads": local.ssm_heads,
                      "mamba": local.mamba_width, "mlstm": local.mlstm_width,
                      "mlstm_in": local.mlstm_input_width,
                      "slstm": local.slstm_width,
                      "slstm_mlp": local.slstm_mlp_width}
        out[case] = r
    out["pool"] = {case: _pool_ops(group, models[case]) for case in CASES}
    out["whisper"] = _whisper(whisper, wparams)
    return out


# ---------------------------------------------------------------------------
# the tests (JAX on this side only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    import jax
    from repro.models.registry import get_smoke_model as jax_smoke
    out = {}
    for case, (arch, extra, seed) in CASES.items():
        jm = jax_smoke(arch, **extra)
        jp = jm.init_params(jax.random.PRNGKey(seed))
        out[case] = (jm, jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def jax_whisper():
    import jax
    from repro.models.registry import get_smoke_model as jax_smoke
    jm = jax_smoke(WHISPER)
    jp = jm.init_params(jax.random.PRNGKey(4))
    return jm, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def tp(jax_side, jax_whisper):
    return spawn(_ranks, 2, ({c: v[2] for c, v in jax_side.items()},
                             jax_whisper[2]),
                 device="cpu", guard=True, timeout_s=600,
                 collective_timeout_s=120)


@pytest.fixture(scope="module")
def engine_tokens(jax_side):
    """The JAX single-device ``Engine``'s greedy tokens per prompt."""
    from repro.runtime.engine import Engine
    return {case: [np.asarray(Engine(jm, jp).generate(
        prompt[None], max_new_tokens=NEW, cache_len=MAX_LEN).tokens[0]
        ).tolist() for _, prompt in _workload()]
        for case, (jm, jp, _) in jax_side.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_faas_kinds_and_tokens_match_the_jax_engine(tp, engine_tokens, case):
    """Cold, fork (streamed) and warm over the dense slot pool give the
    single-device JAX ``Engine``'s greedy tokens."""
    rows = tp[case]["faas"]
    assert [r["kind"] for r in rows] == ["cold", "fork", "warm"]
    assert rows[0]["streamed"] and rows[1]["streamed"]
    assert not rows[2]["streamed"]
    assert [r["tokens"] for r in rows] == engine_tokens[case]


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_logits_within_fp32_tolerance(tp, jax_side, case):
    import jax.numpy as jnp
    jm, jp, _ = jax_side[case]
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(_workload()[0][1][None])},
                         jm.make_cache(1, MAX_LEN))
    want = np.asarray(want)
    got = tp[case]["logits"]
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


@pytest.mark.parametrize("case", list(CASES))
def test_sequential_engine_under_the_plan_matches_jax(tp, jax_side, case):
    from repro.runtime.engine import Engine
    jm, jp, _ = jax_side[case]
    want = Engine(jm, jp).generate(_batch(), NEW, cache_len=MAX_LEN).tokens
    np.testing.assert_array_equal(tp[case]["engine"], np.asarray(want))


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_per_model_call(tp, case):
    cfg = _cfg(case)
    want = _expected_collectives(cfg)
    assert want == {"zamba": 14, "xlstm": 10, "xlstm-split": 11}[case]
    assert tp[case]["prefill_collectives"] == want
    assert tp[case]["decode_collectives"] == want


@pytest.mark.parametrize("case", list(CASES))
def test_the_rank_holds_its_heads_and_widths(tp, case):
    """The rank's configuration: half the heads and their widths; the
    mLSTM's input whole; the sLSTM post-MLP halved only where 2 divides
    it (128 at d_model 96, not 85 at 64)."""
    cfg, local = _cfg(case), tp[case]["local"]
    assert local["heads"] == cfg.n_heads // 2
    if cfg.family == "zamba":
        assert local["ssm_heads"] == cfg.ssm_heads // 2
        assert local["mamba"] == cfg.mamba_width // 2
        return
    assert local["mlstm"] == cfg.mlstm_width // 2
    assert local["mlstm_in"] == cfg.mlstm_input_width
    assert local["slstm"] == cfg.d_model // 2
    split = case == "xlstm-split"
    assert cfg.slstm_mlp_width == (128 if split else 85)
    assert local["slstm_mlp"] == cfg.slstm_mlp_width // (2 if split else 1)


def _meta_launches(cfg, rank: int, step: str) -> dict:
    """The kernels one call of rank ``rank``'s model reaches, on ``meta``
    tensors under the plan (the collectives pass through on ``meta``)."""
    from repro_torch.kernels import meta
    plan = sharding.serving_plan(sharding.ServingMesh(1, 2), rank=rank)
    local = sharding.local_config(cfg, 2, rank)
    specs = transformer.param_specs(local)
    B = 1 if step == "prefill" else 2
    cache = transformer.make_cache(local, B, 16, device="meta")
    obs = _KernelNames()
    meta.add_observer(obs)
    try:
        with sharding.use_plan(plan, cfg):
            if step == "prefill":
                toks = torch.zeros((B, 8), dtype=torch.int32, device="meta")
                transformer.prefill(specs, local, toks, cache)
            else:
                toks = torch.zeros((B, 1), dtype=torch.int32, device="meta")
                transformer.decode_step(specs, local, cache, toks, 5)
    finally:
        meta.remove_observer(obs)
    return obs.calls


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_kernel_launches_per_call_under_the_plan(arch, size):
    """Every split row goes through the split-row form (two launches),
    every other norm through the one-launch kernel; zamba's Mamba2 prefill
    through ``ssd_scan`` and its shared block through flash and decode
    attention, at the rank's heads."""
    cfg = get_config(arch)
    if size == "smoke":
        cfg = reduced(cfg)
    if cfg.family == "zamba":
        L, U = cfg.n_layers, transformer.n_units(cfg)
        norms = {"rmsnorm": L + 2 * U + 1, "rmsnorm_split": 2 * L}
        want = {"prefill": {**norms, "ssd_scan": L, "flash_attention": U},
                "decode": {**norms, "decode_attention": U}}
    else:
        units, m_per = transformer.xlstm_units(cfg)
        M = units * m_per
        norms = {"rmsnorm": M + 2 * units + 1,
                 "rmsnorm_split": 2 * (M + units)}
        want = {"prefill": norms, "decode": norms}
    for step in ("prefill", "decode"):
        for rank in range(2):
            assert _meta_launches(cfg, rank, step) == want[step], (step, rank)


@pytest.mark.parametrize("case", list(CASES))
def test_fork_bytes_per_rank_sum_to_one_device_plus_replicas(tp, jax_side,
                                                             case):
    """Each rank streams its shard: the ranks' bytes add up to the
    one-device fork's plus what every rank holds alike (norms, the
    mLSTM's conv and ``x_inner`` columns, Mamba2's B and C columns, a
    replicated sLSTM post-MLP) once more."""
    from repro_torch.runtime import FaaSRuntime
    cfg = _cfg(case)
    m = get_model(cfg, device="cpu")
    p = convert.params_from_jax(jax_side[case][2], cfg, device="cpu")
    rt = FaaSRuntime(device="cpu", n_slots=2, max_len=MAX_LEN, trace_seq=8,
                     prewarm=False)
    rt.deploy(tidal.static_function("one", m, p), {})
    _, one = rt.server.fork("one", {})
    for row in tp[case]["faas"][:2]:
        streamed, reused, replicated = zip(*row["fork"])
        assert len(set(replicated)) == 1 and replicated[0] > 0
        assert sum(streamed) + sum(reused) == (
            one.streamed_bytes + one.reused_bytes + replicated[0])
        assert len(set(streamed)) == 1       # equal shards


@pytest.mark.parametrize("case", list(CASES))
def test_dense_pool_identical_on_ranks_and_equal_to_jax(tp, jax_side, case):
    """The dense slot pool's free list is the same on both ranks and the
    JAX pool's, and each rank's arena is the global one cut by
    ``cache_specs``: recurrent states by heads, Mamba2's conv window by
    its x channels with B and C whole, the mLSTM's conv window whole."""
    from repro.runtime.kv_pool import KVCachePool
    jm = jax_side[case][0]
    pool = KVCachePool(jm, 3, MAX_LEN)
    s0 = pool.alloc()
    s1 = pool.alloc()
    pool.release(s0)
    s2 = pool.alloc()
    got = tp["pool"][case]
    assert got["slots"] == [s0, s1, s2]
    assert got["states"][0] == got["states"][1] == [list(pool._free),
                                                    pool.n_free]
    cfg = _cfg(case)
    one = get_model(cfg, device="cpu")
    full = transformer.make_cache(cfg, 3, MAX_LEN, device="meta")
    specs = dict(named_leaves(sharding.cache_specs(one, full, sharding.ServingMesh(
        1, 2), batch=3)))
    want = {}
    for path, t in named_leaves(full):
        shape, spec = list(t.shape), specs[path]
        d = spec.model_dim
        if d is not None:
            shape[d] = sum(s // g for s, g in spec.parts or ((shape[d], 2),))
        want[path] = tuple(shape)
    assert got["arenas"] == [want, want]


def test_split_row_norm_equals_the_whole_row_and_a_slice_alone_does_not():
    """The split-row form's plain versions: the slices' sums of squares
    added over the 'ranks', then each slice scaled, put back together,
    equal the whole row's norm; a slice normalised alone (its own mean)
    does not, and neither does a slice scaled by the wrong width."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 64, generator=g)
    scale = torch.randn(64, generator=g)
    whole = ref.rmsnorm_ref(x, scale, 1e-6)
    xs, ss = x.chunk(2, dim=-1), scale.chunk(2)
    total = sum(ref.rmsnorm_sumsq_ref(s) for s in xs)
    split = torch.cat([ref.rmsnorm_apply_ref(s, total, c, 64, 1e-6)
                       for s, c in zip(xs, ss)], dim=-1)
    torch.testing.assert_close(split, whole, rtol=1e-6, atol=1e-6)
    alone = torch.cat([ref.rmsnorm_ref(s, c, 1e-6) for s, c in zip(xs, ss)],
                      dim=-1)
    assert (alone - whole).abs().max() > 1e-2
    narrow = torch.cat([ref.rmsnorm_apply_ref(s, total, c, 32, 1e-6)
                        for s, c in zip(xs, ss)], dim=-1)
    assert (narrow - whole).abs().max() > 1e-2
    # the wrapper's route: the plain versions on CPU tensors, the reduce
    # between them, the whole-row norm without a plan
    got = ops.rmsnorm_split(xs[0], ss[0], 1e-6, 64, lambda s: total)
    torch.testing.assert_close(got, whole[..., :32], rtol=1e-6, atol=1e-6)
    from repro_torch.models.layers import split_rmsnorm
    torch.testing.assert_close(split_rmsnorm(x, scale), whole)


@pytest.mark.parametrize("arch,lora", [(ZAMBA, False), (XLSTM, False),
                                       (ZAMBA, True)])
def test_serve_cli_tp2_on_the_cpu(arch, lora):
    """``serve.py --tp 2`` serves zamba and xLSTM over two gloo ranks, and
    ``--lora --tp 2`` zamba's shared block's ``wq``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--tp", "2", "--arch", arch, "--functions", "2", "--requests", "6",
         "--prompt-len", "16", "--max-new", "4"] + (["--lora"] if lora else []),
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [l for l in res.stdout.splitlines() if l.startswith("req")]
    assert len(lines) == 6
    kinds = {l.split()[3 if lora else 2] for l in lines}
    assert kinds <= {"cold", "fork", "warm"} and "cold" in kinds
    assert "2 ranks" in res.stdout and "gloo" in res.stdout


def test_whisper_under_a_serving_plan_matches_jax(tp, jax_whisper):
    """Whisper at tp = 2 (2 of 4 heads per rank): the prefill's and each
    greedy decode step's logits within 1e-5 of the largest |logit| of the
    JAX ``prefill`` / ``decode_step``'s, the tokens equal; the sequential
    ``Engine`` refuses the plan (the reference's takes none)."""
    import jax.numpy as jnp
    jm, jp, _ = jax_whisper
    frames, toks = _whisper_inputs(jm.cfg)
    logits, cache = jm.prefill(jp, {"frames": jnp.asarray(frames),
                                    "tokens": jnp.asarray(toks)},
                               jm.make_cache(2, WHISPER_FRAMES))
    want, tokens = [np.asarray(logits)], [np.asarray(logits).argmax(-1)]
    for i in range(WHISPER_STEPS):
        logits, cache = jm.decode_step(
            jp, cache, {"tokens": jnp.asarray(tokens[-1][:, None], jnp.int32)},
            toks.shape[1] + i)
        want.append(np.asarray(logits))
        tokens.append(want[-1].argmax(-1))
    want = np.stack(want)
    got = tp["whisper"]
    assert got["heads"] == jm.cfg.n_heads // 2
    assert np.abs(got["logits"] - want).max() <= LOGIT_TOL * np.abs(want).max()
    np.testing.assert_array_equal(got["tokens"], np.stack(tokens, 1))
    assert "sequential Engine" in got["refused"]
