"""The port's sharding plans against ``repro.distributed.sharding``.

The JAX package places every leaf by a shape heuristic (largest divisible
axis, ties to the last); the port places by role in the Megatron layout.
The specs are compared leaf by leaf over the same mesh (the port's
``ServingMesh(1, 2)``, whose ``shape`` and ``axis_names`` the JAX
functions read), and every difference must be one of the listed
placements (ROADMAP Queue 3, "Differences the reference itself has"):
nothing else differs, at the smoke shapes and at the full shapes of
llama3-8b, phi3.5-moe and deepseek-v3.  Then the arithmetic the ranks
rely on: shards reassemble the leaf, ``init_params`` under a plan keeps
the slice of the one-device draw (experts and MLA heads too), every
cache spec cuts the global arena to the one a rank's pool allocates,
``validate_specs``, the kernels' head check and the refusals that name
their ROADMAP items.  No process group is needed.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import sharding as jax_sharding  # noqa: E402
from repro.models.registry import get_model as jax_model  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro.utils import path_str  # noqa: E402
from repro_torch.convert import group_lengths, port_names  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import P, ServingMesh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import get_model, get_smoke_model  # noqa: E402
from repro_torch.utils import named_leaves  # noqa: E402

MESH = ServingMesh(1, 2)

# where the port places a leaf otherwise than the JAX heuristic (JAX's
# spec, the port's), at tp = 2
ATTN_DIFFS = {
    # JAX: rows (d_model is the larger axis); port: the KV heads' columns
    "blocks.attn.wk": (("model", None), (None, "model")),
    "blocks.attn.wv": (("model", None), (None, "model")),
    # JAX: the output axis (ties go last); port: rows, then one all_reduce
    "blocks.attn.wo": ((None, "model"), ("model", None)),
    # JAX shards the norms' scales; the port replicates them
    "blocks.attn_norm": (("model",), (None,)),
    "blocks.mlp_norm": (("model",), (None,)),
    "final_norm": (("model",), (None,)),
}
# one KV head: every rank keeps it (JAX splits wk / wv by rows)
ONE_KV_DIFFS = {**ATTN_DIFFS,
                "blocks.attn.wk": (("model", None), (None, None)),
                "blocks.attn.wv": (("model", None), (None, None))}
# moe: JAX splits the router's larger axis (d_model); every rank routes
# every token with the whole router.  The experts agree (the expert axis)
ROUTER_DIFF = {"blocks.moe.router": (("model", None), (None, None))}
# the shared expert placed by role (columns, columns, rows); JAX by shape
SHARED_DIFFS = {"blocks.moe.shared.w_gate": (("model", None), (None, "model")),
                "blocks.moe.shared.w_up": (("model", None), (None, "model")),
                "blocks.moe.shared.w_down": ((None, "model"), ("model", None))}
NORM_DIFFS = {k: ATTN_DIFFS[k] for k in ("blocks.attn_norm",
                                         "blocks.mlp_norm", "final_norm")}
# MLA: the a-side replicated and wq_b / wkv_b on their columns as in JAX;
# wo by rows (JAX takes the tie at the smoke shape's 64 x 64 to the last
# axis, and rows at the full [16384, 7168])
MLA_SMOKE_DIFFS = {**NORM_DIFFS, **ROUTER_DIFF, **SHARED_DIFFS,
                   "blocks.attn.wo": ATTN_DIFFS["blocks.attn.wo"]}
MLA_FULL_DIFFS = {**NORM_DIFFS, **ROUTER_DIFF, **SHARED_DIFFS}
MOE_DIFFS = {"smoke": {**ONE_KV_DIFFS, **ROUTER_DIFF},
             "full": {**ATTN_DIFFS, **ROUTER_DIFF}}
PHI, DSV3 = "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"


def _param_diffs(jm, tm, with_parts: bool = False) -> dict:
    """{JAX path: (JAX's spec, the port's)} where they differ;
    ``with_parts`` also lists every port spec that cuts a dimension in
    uneven parts (its ``parts`` third), which JAX's even split is not."""
    jspecs = jax.tree_util.tree_leaves_with_path(
        jax_sharding.param_specs(jm, MESH),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    tspecs = dict(named_leaves(sharding.param_specs(tm, MESH)))
    lengths = group_lengths(tm.param_specs())
    out = {}
    for p, spec in jspecs:
        path = path_str(p)
        names = port_names(path, lengths)
        want = tuple(spec)[1:] if names != [path] else tuple(spec)
        got = {(tuple(tspecs[n]), tspecs[n].parts) for n in names}
        assert len(got) == 1, path           # every layer alike
        got, parts = got.pop()
        want = want + (None,) * (len(got) - len(want))
        if with_parts and (got != want or parts):
            out[path] = (want, got, parts)
        elif got != want:
            out[path] = (want, got)
    assert set(tspecs) == {n for p, _ in jspecs
                           for n in port_names(path_str(p), lengths)}
    return out


@pytest.mark.parametrize("kv,diffs", [(2, ATTN_DIFFS), (1, ONE_KV_DIFFS)])
def test_smoke_param_specs_differ_from_jax_only_as_listed(kv, diffs):
    jm = jax_smoke("smollm-135m", n_layers=2, n_kv_heads=kv)
    tm = get_smoke_model("smollm-135m", device="cpu", n_layers=2,
                         n_kv_heads=kv)
    assert _param_diffs(jm, tm) == diffs


def test_llama3_8b_param_specs_differ_from_jax_only_as_listed():
    assert _param_diffs(jax_model("llama3-8b"),
                        get_model("llama3-8b", device="cpu")) == ATTN_DIFFS


@pytest.mark.parametrize("arch,size,diffs", [
    (PHI, "smoke", MOE_DIFFS["smoke"]), (PHI, "full", MOE_DIFFS["full"]),
    (DSV3, "smoke", MLA_SMOKE_DIFFS), (DSV3, "full", MLA_FULL_DIFFS)])
def test_moe_and_mla_param_specs_differ_from_jax_only_as_listed(arch, size,
                                                                diffs):
    """Experts over the expert axis and MLA's b-side on its head columns
    as in JAX; the router replicated, the shared expert by role, and the
    attention and norms as in the dense family."""
    if size == "smoke":
        jm, tm = (jax_smoke(arch, n_layers=2),
                  get_smoke_model(arch, device="cpu", n_layers=2))
    else:
        jm, tm = jax_model(arch), get_model(arch, device="cpu")
    assert _param_diffs(jm, tm) == diffs


@pytest.mark.parametrize("arch,experts", [(PHI, 8), (DSV3, 128)])
def test_moe_and_mla_roles_at_full_width(arch, experts):
    """Each rank holds E / 2 whole experts; MLA's a-side is replicated and
    its b-side split on heads; the rank's configuration keeps the global
    expert count and MLA's latent widths."""
    cfg = get_model(arch, device="cpu").cfg
    specs = dict(named_leaves(sharding.config_param_specs(cfg, 2)))
    for leaf in ("w_gate", "w_up", "w_down"):
        assert specs[f"layers.0.moe.experts.{leaf}"] == P("model", None, None)
    assert specs["layers.0.moe.router"] == P(None, None)
    for r in range(2):
        local = sharding.local_config(cfg, 2, rank=r)
        assert local.expert_range == (r * experts, (r + 1) * experts)
        assert local.n_experts == cfg.n_experts
        assert local.moe_d_ff == cfg.moe_d_ff
        assert local.shared_width == cfg.shared_width // 2
        assert local.n_heads == cfg.n_heads // 2
        assert (local.kv_lora_rank, local.qk_rope_dim) == (
            cfg.kv_lora_rank, cfg.qk_rope_dim)
    shapes = dict(named_leaves(transformer.param_specs(local)))
    assert shapes["layers.0.moe.experts.w_gate"].shape[0] == experts
    if cfg.use_mla:
        for leaf in ("wq_a", "wkv_a", "q_a_norm", "kv_a_norm"):
            assert specs[f"layers.0.attn.{leaf}"].model_dim is None
        assert specs["layers.0.attn.wq_b"] == P(None, "model")
        assert specs["layers.0.attn.wkv_b"] == P(None, "model")
        assert specs["layers.0.attn.wo"] == P("model", None)
        assert shapes["layers.0.attn.wkv_b"].shape == (
            cfg.kv_lora_rank, 64 * (cfg.qk_nope_dim + cfg.v_head_dim))
    assert sharding.validate_specs(
        sharding.config_param_specs(cfg, 2), transformer.param_specs(cfg),
        MESH) == []


@pytest.mark.parametrize("kv", [2, 1])
def test_cache_specs_against_jax(kv):
    """Dense and paged (fp and int8) caches: equal to JAX's with the KV
    heads split; with one KV head JAX splits head_dim, the port keeps
    the head on every rank."""
    jm = jax_smoke("smollm-135m", n_layers=2, n_kv_heads=kv)
    tm = get_smoke_model("smollm-135m", device="cpu", n_layers=2,
                         n_kv_heads=kv)
    got = sharding.cache_specs(tm, transformer.make_cache(
        tm.cfg, 4, 16, device="meta"), MESH, batch=4)
    want = jax_sharding.cache_specs(jm, jm.make_cache(4, 16, abstract=True),
                                    MESH, batch=4)
    for kv_dtype in (None, "int8"):
        pg = sharding.paged_cache_specs(transformer.make_paged_cache(
            tm.cfg, 9, 8, device="meta", kv_dtype=kv_dtype), MESH, tm.cfg)
        pw = jax_sharding.paged_cache_specs(jax.eval_shape(
            lambda: jm.make_paged_cache(9, 8, kv_dtype=kv_dtype)), MESH)
        got.update({f"paged.{kv_dtype}.{k}": v for k, v in pg.items()})
        want.update({f"paged.{kv_dtype}.{k}": v for k, v in pw.items()})
    diff = {k: (tuple(want[k]), tuple(v)) for k, v in got.items()
            if tuple(v) != tuple(want[k])}
    if kv == 2:
        assert diff == {}
    else:
        head_dim = (None, None, None, None, "model")
        assert diff == {
            "k": ((None, "data", None, None, "model"),
                  (None, "data", None, None, None)),
            "v": ((None, "data", None, None, "model"),
                  (None, "data", None, None, None)),
            "paged.None.k": (head_dim, (None,) * 5),
            "paged.None.v": (head_dim, (None,) * 5),
            "paged.int8.k": (head_dim, (None,) * 5),
            "paged.int8.v": (head_dim, (None,) * 5)}


def test_latent_cache_specs_against_jax():
    """MLA's dense and paged (fp and int8) latent caches: the port
    replicates ``c_kv`` and ``k_rope`` over 'model' (every rank's heads
    read the whole latent), where JAX splits their last axis
    (``kv_lora_rank``, ``qk_rope_dim``); the int8 scales agree."""
    jm = jax_smoke(DSV3, n_layers=2)
    tm = get_smoke_model(DSV3, device="cpu", n_layers=2)
    got = sharding.cache_specs(tm, transformer.make_cache(
        tm.cfg, 4, 16, device="meta"), MESH, batch=4)
    want = jax_sharding.cache_specs(jm, jm.make_cache(4, 16, abstract=True),
                                    MESH, batch=4)
    for kv_dtype in (None, "int8"):
        pg = sharding.paged_cache_specs(transformer.make_paged_cache(
            tm.cfg, 9, 8, device="meta", kv_dtype=kv_dtype), MESH, tm.cfg)
        pw = jax_sharding.paged_cache_specs(jax.eval_shape(
            lambda: jm.make_paged_cache(9, 8, kv_dtype=kv_dtype)), MESH)
        got.update({f"paged.{kv_dtype}.{k}": v for k, v in pg.items()})
        want.update({f"paged.{kv_dtype}.{k}": v for k, v in pw.items()})
    diff = {k: (tuple(want[k]), tuple(v)) for k, v in got.items()
            if tuple(v) != tuple(want[k])}
    split, whole = (None, None, None, "model"), (None,) * 4
    assert diff == {
        "c_kv": ((None, "data", None, "model"), (None, "data", None, None)),
        "k_rope": ((None, "data", None, "model"), (None, "data", None, None)),
        "paged.None.c_kv": (split, whole), "paged.None.k_rope": (split, whole),
        "paged.int8.c_kv": (split, whole), "paged.int8.k_rope": (split, whole)}


def _shard_shape(shape: tuple, spec) -> tuple:
    """The shape of one rank's piece of a ``shape`` leaf under ``spec``."""
    d = spec.model_dim
    if d is None:
        return tuple(shape)
    parts = spec.parts or ((shape[d], MESH.model),)
    out = list(shape)
    out[d] = sum(seg // groups for seg, groups in parts)
    return tuple(out)


@pytest.mark.parametrize("arch,extra", [
    ("smollm-135m", {"n_kv_heads": 2}), ("smollm-135m", {"n_kv_heads": 1}),
    (PHI, {}), (DSV3, {})], ids=["kv2", "kv1", "moe", "mla"])
def test_cache_specs_cut_the_arena_a_ranks_pool_allocates(arch, extra):
    """Every dense and paged (fp and int8) cache spec cuts the global
    leaf to the leaf a rank's model allocates: K/V heads split or kept,
    MLA's latent whole."""
    from repro_torch.runtime.kv_pool import PagedKVCachePool
    cfg = get_smoke_model(arch, device="cpu", n_layers=2, **extra).cfg
    one = get_model(cfg, device="cpu")
    for r in range(2):
        rank = get_model(cfg, device="cpu",
                         plan=sharding.serving_plan(MESH, rank=r))
        dense = sharding.cache_specs(one, transformer.make_cache(
            cfg, 4, 16, device="meta"), MESH, batch=4)
        for k, t in transformer.make_cache(cfg, 4, 16, device="meta").items():
            assert _shard_shape(tuple(t.shape), dense[k]) == tuple(
                rank.make_cache(4, 16)[k].shape), (k, r)
        for kv_dtype in (None, "int8"):
            full = transformer.make_paged_cache(cfg, 9, 8, device="meta",
                                                kv_dtype=kv_dtype)
            specs = sharding.paged_cache_specs(full, MESH, cfg)
            pool = PagedKVCachePool(rank, 2, 16, page_size=8, n_pages=9,
                                    kv_dtype=kv_dtype)
            assert set(pool.cache) == set(full)
            for k, t in full.items():
                assert _shard_shape(tuple(t.shape), specs[k]) == tuple(
                    pool.cache[k].shape), (k, kv_dtype, r)


def test_validate_specs_llama3_8b_and_a_violation():
    tm = get_model("llama3-8b", device="cpu")
    specs = sharding.param_specs(tm, MESH)
    assert sharding.validate_specs(specs, transformer.param_specs(tm.cfg),
                                   MESH) == []
    bad = sharding.validate_specs({"w": P(None, "model")},
                                  {"w": torch.empty(4, 3, device="meta")}, MESH)
    assert bad == [("w", 1, 3, 2)]


def _check_sharded_init(single) -> None:
    one = single.init_params(seed=4)
    ranks = [get_model(single.cfg, device="cpu",
                       plan=sharding.serving_plan(MESH, rank=r)
                       ).init_params(seed=4) for r in range(2)]
    specs = dict(named_leaves(sharding.config_param_specs(single.cfg, 2)))
    local = dict(named_leaves(transformer.param_specs(
        sharding.local_config(single.cfg, 2, 0))))
    shards = [dict(named_leaves(r)) for r in ranks]
    for s in shards:        # a copy of its own, never a view of the draw
        for t in s.values():
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    for path, full in named_leaves(one):
        spec = specs[path]
        assert tuple(shards[0][path].shape) == tuple(local[path].shape)
        d = spec.model_dim
        if d is None:
            assert all(torch.equal(s[path], full) for s in shards)
        else:
            assert torch.equal(torch.cat([s[path] for s in shards], dim=d),
                               full), path


@pytest.mark.parametrize("kv", [2, 1])
def test_sharded_init_keeps_each_ranks_slice_of_one_draw(kv):
    """``init_params`` under a plan draws every full leaf in the one-device
    order and keeps the rank's slice: the two ranks' shards reassemble
    the tp = 1 weights of the same seed (replicated leaves whole on each)."""
    _check_sharded_init(get_smoke_model("smollm-135m", device="cpu",
                                        n_layers=2, n_kv_heads=kv))


@pytest.mark.parametrize("arch", [PHI, DSV3])
def test_sharded_init_keeps_each_ranks_experts_and_heads(arch):
    """The same for the experts (rank r keeps experts [r E/2, (r+1) E/2)),
    the shared expert and MLA's head columns."""
    _check_sharded_init(get_smoke_model(arch, device="cpu", n_layers=2))


def test_fused_leaves_split_per_part():
    """``wqkv`` splits q, k and v each by heads and ``w_gu`` gate and up
    each by ``d_ff``; with fewer KV heads than ranks each rank keeps the
    KV head its query heads read."""
    cfg = get_smoke_model("smollm-135m", device="cpu", n_kv_heads=1).cfg
    cfg = cfg.replace(fused_qkv=True, fused_glu=True, n_heads=4)
    H, KV, hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    specs = dict(named_leaves(sharding.config_param_specs(cfg, 2)))
    wqkv = torch.arange(cfg.d_model * (H + 2 * KV) * hd, dtype=torch.float32
                        ).reshape(cfg.d_model, -1)
    w_gu = torch.arange(cfg.d_model * 2 * F, dtype=torch.float32
                        ).reshape(cfg.d_model, -1)
    for r in range(2):
        plan = sharding.serving_plan(MESH, rank=r)
        q, k, v = wqkv.split([H * hd, KV * hd, KV * hd], dim=1)
        want = torch.cat([q.chunk(2, dim=1)[r], k, v], dim=1)
        got = sharding.shard_for_rank(wqkv, specs["layers.0.attn.wqkv"], plan)
        assert torch.equal(got, want)
        g, u = w_gu.chunk(2, dim=1)
        got = sharding.shard_for_rank(w_gu, specs["layers.0.mlp.w_gu"], plan)
        assert torch.equal(got, torch.cat([g.chunk(2, dim=1)[r],
                                           u.chunk(2, dim=1)[r]], dim=1))


def test_kv_heads_fewer_than_ranks_are_shared_by_query_group():
    """KV = 2 over 4 ranks: ranks 0-1 keep KV head 0, ranks 2-3 head 1."""
    cfg = get_smoke_model("smollm-135m", device="cpu", n_kv_heads=2).cfg
    mesh = ServingMesh(1, 4)
    spec = dict(named_leaves(sharding.config_param_specs(cfg, 4)))[
        "layers.0.attn.wk"]
    assert spec == P(None, "model", parts=((2 * cfg.head_dim, 2),))
    wk = torch.arange(cfg.d_model * 2 * cfg.head_dim).reshape(cfg.d_model, -1)
    heads = wk.chunk(2, dim=1)
    for r in range(4):
        got = sharding.shard_for_rank(wk, spec,
                                      sharding.serving_plan(mesh, rank=r))
        assert torch.equal(got, heads[r // 2])
    assert sharding.local_config(cfg, 4, 0).n_kv_heads == 1


def test_kernels_check_the_ranks_heads():
    cfg = get_smoke_model("smollm-135m", device="cpu", n_kv_heads=2).cfg
    q = torch.randn(1, 4, 3, cfg.head_dim)          # all 4 heads
    k = torch.randn(1, 2, 3, cfg.head_dim)
    with sharding.use_plan(sharding.serving_plan(MESH, rank=0), cfg):
        assert sharding.local_heads() == (2, 1)
        with pytest.raises(ValueError, match="this rank holds 2 / 1"):
            ops.flash_attention(q, k, k, causal=True)
        out = ops.flash_attention(q[:, :2], k[:, :1], k[:, :1], causal=True)
    assert out.shape == (1, 2, 3, cfg.head_dim)
    assert sharding.local_heads() is None


@pytest.mark.parametrize("arch,item", [("whisper-medium", "sequential Engine"),
                                       ("zamba2-2.7b", None),
                                       ("xlstm-1.3b", None)])
def test_other_families_under_a_plan_name_their_item(arch, item):
    """zamba, xLSTM and whisper build under a plan (the rank's heads;
    whisper's ``Model.prefill`` and ``decode_step`` serve under it); the
    sequential ``Engine`` refuses whisper under a plan naming the
    reference's own limit: its ``Engine`` takes no plan."""
    from repro_torch.runtime.engine import Engine
    plan = sharding.serving_plan(MESH, rank=0)
    model = get_smoke_model(arch, device="cpu", plan=plan)
    assert model.local_cfg.n_heads == model.cfg.n_heads // 2
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            Engine(model, model.init_params())


def test_data_axis_and_training_specs_name_their_items():
    # a data axis serves (one rank group per instance): the plan of one
    # data slice, as the reference's Mesh(mesh.devices[i:i + 1])
    plan = sharding.serving_plan(ServingMesh(2, 2), rank=1, instance=1)
    assert (plan.mesh, plan.tp, plan.rank, plan.instance) == (MESH, 2, 1, 1)
    tm1 = get_smoke_model("smollm-135m", device="cpu", plan=plan)
    assert tm1.local_cfg == get_smoke_model(
        "smollm-135m", device="cpu",
        plan=sharding.serving_plan(MESH, rank=1)).local_cfg
    # training under a plan covers every family: the recurrent and enc-dec
    # models build under a training plan with the rank's heads and their
    # pieces of one draw (whisper included, which no serving plan takes);
    # what is left names item 10: one KV head every rank shares through a
    # fused wqkv, and a sequence-parallel step (K/V heads shared by some
    # but not all ranks train: tests/test_torch_tp_train.py)
    plan = sharding.training_plan(MESH, rank=1)
    for arch in ("zamba2-2.7b", "xlstm-1.3b", "whisper-medium"):
        tm = get_smoke_model(arch, device="cpu", plan=plan)
        assert tm.local_cfg.n_heads == tm.cfg.n_heads // 2
        one = dict(named_leaves(get_smoke_model(arch, device="cpu").init_params(2)))
        specs = sharding.leaf_param_specs(tm, MESH)
        for path, piece in named_leaves(tm.init_params(2)):
            assert torch.equal(piece, plan.shard(one[path], specs[path])), path
    batch = {"tokens": np.zeros((1, 4), np.int32),
             "labels": np.zeros((1, 4), np.int32)}
    shared = get_smoke_model("llama3-8b", device="cpu", fused_qkv=True,
                             plan=sharding.training_plan(ServingMesh(1, 4)))
    with pytest.raises(NotImplementedError, match="item 10"):
        shared.loss(shared.init_params(), batch)
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_loop import make_train_step
    with pytest.raises(NotImplementedError, match="item 10"):
        make_train_step(get_smoke_model("zamba2-2.7b", device="cpu", plan=plan),
                        OptimizerConfig(), seq_parallel=True)


@pytest.mark.parametrize("arch,replace,tp,match", [
    (PHI, {"n_experts": 6}, 4, "6 experts"),
    (DSV3, {"n_heads": 126}, 4, "126 query heads"),
    (DSV3, {"moe_d_ff": 2050}, 4, "shared experts' width 2050"),
    ("llama3-8b", {"d_ff": 14338}, 4, "d_ff 14338")])
def test_a_model_axis_that_does_not_divide_raises(arch, replace, tp, match):
    """``check_tp`` accepts phi3.5-moe and deepseek-v3 as configured, and
    raises where the model axis does not divide the experts, MLA's heads,
    the shared experts' width or a dense MLP's ``d_ff``."""
    cfg = get_model(arch, device="cpu").cfg
    sharding.check_tp(cfg, tp)
    with pytest.raises(ValueError, match=match):
        sharding.check_tp(cfg.replace(**replace), tp)


@pytest.mark.parametrize("arch", ["smollm-135m", PHI])
def test_lora_under_a_plan_names_its_item(arch):
    """LoRA under TP (on a dense or a moe base) serves: a merged
    ``lora_function``'s initializer gives each rank its shard of the
    one-device merged weight (the delta cut as its target is), and the
    static leaves its shard of the base."""
    from repro_torch.core import api as tidal
    one = get_smoke_model(arch, device="cpu", n_layers=2)
    want = tidal.lora_function("l", one, one.init_params(),
                               ["blocks.attn.wq"]).run_initializer(
        {"adapter": "adapter-1"})[0]
    specs = sharding.leaf_param_specs(one, MESH)
    for rank in range(2):
        plan = sharding.serving_plan(MESH, rank=rank)
        model = get_smoke_model(arch, device="cpu", n_layers=2, plan=plan)
        got, fps = tidal.lora_function("l", model, model.init_params(),
                                       ["blocks.attn.wq"]).run_initializer(
            {"adapter": "adapter-1"})
        assert fps["layers.1.attn.wq"][0] == "add"
        for path in ("layers.0.attn.wq", "layers.1.attn.wq",
                     "layers.0.attn.wo"):
            full = dict(named_leaves(want))[path].materialize()
            mine = dict(named_leaves(got))[path].materialize()
            assert torch.equal(mine, plan.shard(full, specs[path])), path


# an adapter bank's placements at tp = 2 (a: [L, N, in, r], b: [L, N, r,
# out]): the factor on the target's split side follows the target
BANK_SPECS = {
    2: {"wq": (P(None, None, None, None), P(None, None, None, "model")),
        "wk": (P(None, None, None, None), P(None, None, None, "model")),
        "wv": (P(None, None, None, None), P(None, None, None, "model")),
        "wo": (P(None, None, "model", None), P(None, None, None, None))},
    # one KV head: every rank keeps it, so wk / wv's b is whole
    1: {"wq": (P(None, None, None, None), P(None, None, None, "model")),
        "wk": (P(None, None, None, None), P(None, None, None, None)),
        "wv": (P(None, None, None, None), P(None, None, None, None)),
        "wo": (P(None, None, "model", None), P(None, None, None, None))}}
TARGETS = ("wq", "wk", "wv", "wo")


@pytest.mark.parametrize("kv", [2, 1])
def test_adapter_bank_and_delta_specs_are_listed(kv):
    """The bank's leaf specs are the listed ones, nothing else differs;
    a merged delta's spec is its target's; and the ranks' shards of a
    loaded bank, put back together per spec, are the one-device bank."""
    from repro_torch.core import api as tidal
    from repro_torch.models import adapters
    one = get_smoke_model("smollm-135m", device="cpu", n_layers=2,
                          n_kv_heads=kv)
    cfg = one.cfg
    specs = sharding.adapter_bank_specs(cfg, TARGETS, 2)
    assert {n: (s["a"], s["b"]) for n, s in specs.items()} == BANK_SPECS[kv]
    leaves = dict(named_leaves(sharding.config_param_specs(cfg, 2)))
    for name in TARGETS:
        assert sharding.lora_delta_spec(cfg, name, 2) == \
            leaves[f"layers.0.attn.{name}"]
    paths = [f"blocks.attn.{n}" for n in TARGETS]
    ad = tidal.lora_checkpoint("ad", one, paths, rank=4, seed=3)
    want = adapters.load_adapter(adapters.make_adapter_bank(one, paths, 3, 4),
                                 2, ad, one, alpha=0.5)
    shards = []
    for rank in range(2):
        model = get_smoke_model("smollm-135m", device="cpu", n_layers=2,
                                n_kv_heads=kv,
                                plan=sharding.serving_plan(MESH, rank=rank))
        bank = adapters.make_adapter_bank(model, paths, 3, 4)
        shards.append(adapters.load_adapter(bank, 2, ad, model, alpha=0.5))
    for name in TARGETS:
        for k in ("a", "b"):
            dim = specs[name][k].model_dim
            if dim is None:
                assert torch.equal(shards[0][name][k], want[name][k])
                assert torch.equal(shards[1][name][k], want[name][k])
            else:
                got = torch.cat([s[name][k] for s in shards], dim=dim)
                assert torch.equal(got, want[name][k]), (name, k)
            assert not shards[1][name][k][:, 0].any()     # row 0 stays null


def test_fused_qkv_logits_match_jax_on_one_device():
    """``fused_qkv`` (and ``fused_glu``) on one device: the converted JAX
    weights give the JAX prefill's logits."""
    import jax.numpy as jnp
    from repro_torch import convert
    jm = jax_smoke("smollm-135m", n_layers=2, n_kv_heads=2, fused_qkv=True,
                   fused_glu=True)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm = get_smoke_model("smollm-135m", device="cpu", n_layers=2,
                         n_kv_heads=2, fused_qkv=True, fused_glu=True)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    toks = np.arange(1, 10, dtype=np.int32)[None]
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.make_cache(1, 16))
    got, _ = tm.prefill(tp, {"tokens": toks}, tm.make_cache(1, 16))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# zamba, xLSTM and whisper: where the port places a leaf otherwise than the
# JAX heuristic at tp = 2, as (JAX's spec, the port's, the port's uneven
# parts).  The norms are replicated and the output projections split by
# rows as in the dense family; besides:
#   * Mamba2's B and C columns (of in_proj and conv_w, and the conv
#     window) whole on every rank: every head reads them (one group); JAX
#     cuts the fused columns evenly;
#   * the mLSTM's x_inner whole (the first half of up_proj, conv_w and
#     the conv window): wq / wk / wv contract over all of it, so a split
#     would cost an all-gather per block; each rank computes its extra
#     D x d_inner product instead (~11% of a block's weights at
#     xlstm-1.3b), no collective;
#   * the mLSTM's gates (w_if, b_if) split per gate by heads, the sLSTM's
#     block-diagonal r by heads (JAX: its last axis), and the sLSTM
#     post-MLP replicated where 2 does not divide its width (85 at the
#     smoke d_model 64);
#   * whisper: the output biases, LayerNorms and dec_pos replicated, and
#     at full width the embedding (its vocabulary 51,865 is odd; JAX
#     splits d_model).
_NORM = (("model",), (None,), None)
_ROWS = ((None, "model"), ("model", None), None)


def _ssm_diffs(cfg) -> dict:
    if cfg.family == "zamba":
        di, bc, H = cfg.mamba_width, 2 * cfg.ssm_state, cfg.ssm_heads
        return {
            "final_norm": _NORM, "mamba.norm": _NORM,
            "shared_attn.attn_norm": _NORM, "shared_attn.mlp_norm": _NORM,
            "shared_attn.attn.wo": _ROWS,
            "mamba.mixer.in_proj": ((None, "model"), (None, "model"),
                                    ((di, 2), (di, 2), (bc, 1), (H, 2))),
            "mamba.mixer.conv_w": ((None, "model"), (None, "model"),
                                   ((di, 2), (bc, 1)))}
    di, H = cfg.mlstm_input_width, cfg.n_heads
    out = {
        "final_norm": _NORM, "mlstm.norm": _NORM, "slstm.norm": _NORM,
        "slstm.mlp_norm": _NORM,
        "mlstm.mixer.conv_w": ((None, "model"), (None, None), None),
        "mlstm.mixer.up_proj": ((None, "model"), (None, "model"),
                                ((di, 1), (di, 2))),
        "mlstm.mixer.w_if": (("model", None), (None, "model"),
                             ((H, 2), (H, 2))),
        "mlstm.mixer.b_if": (("model",), ("model",), ((H, 2), (H, 2))),
        "slstm.mixer.r": ((None, None, "model"), ("model", None, None), None)}
    if not sharding.slstm_mlp_split(cfg, 2):
        out.update({
            "slstm.mixer.mlp.w_gate": (("model", None), (None, None), None),
            "slstm.mixer.mlp.w_up": (("model", None), (None, None), None),
            "slstm.mixer.mlp.w_down": ((None, "model"), (None, None), None)})
    return out


def _whisper_diffs(full: bool) -> dict:
    out = {"dec_pos": ((None, "model"), (None, None), None),
           "enc_ln.bias": _NORM, "enc_ln.scale": _NORM,
           "dec_ln.bias": _NORM, "dec_ln.scale": _NORM,
           "enc_blocks.attn.wo": _ROWS, "enc_blocks.attn.bo": _NORM,
           "enc_blocks.mlp.b2": _NORM, "dec_blocks.mlp.b2": _NORM}
    for ln in ("ln1", "ln2"):
        for leaf in ("bias", "scale"):
            out[f"enc_blocks.{ln}.{leaf}"] = _NORM
    for ln in ("ln1", "ln2", "ln3"):
        for leaf in ("bias", "scale"):
            out[f"dec_blocks.{ln}.{leaf}"] = _NORM
    for attn in ("self_attn", "cross_attn"):
        out[f"dec_blocks.{attn}.wo"] = _ROWS
        out[f"dec_blocks.{attn}.bo"] = _NORM
    if full:
        out["embed"] = ((None, "model"), (None, None), None)
    return out


ZAMBA, XLSTM, WHISPER = "zamba2-2.7b", "xlstm-1.3b", "whisper-medium"


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM, WHISPER])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_recurrent_and_encdec_param_specs_differ_from_jax_only_as_listed(
        arch, size):
    if size == "smoke":
        jm, tm = jax_smoke(arch), get_smoke_model(arch, device="cpu")
    else:
        jm, tm = jax_model(arch), get_model(arch, device="cpu")
    want = (_whisper_diffs(size == "full") if arch == WHISPER
            else _ssm_diffs(tm.cfg))
    assert _param_diffs(jm, tm, with_parts=True) == want


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM, WHISPER])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_recurrent_and_encdec_cache_specs_against_jax(arch, size):
    """The recurrent states by heads as in JAX, zamba's ``attn_kv`` and
    whisper's ``self_kv`` / ``cross_kv`` by heads as in JAX; Mamba2's conv
    window keeps B and C whole and the mLSTM's is whole (its weight's
    placement)."""
    if size == "smoke":
        jm, tm = jax_smoke(arch), get_smoke_model(arch, device="cpu")
    else:
        jm, tm = jax_model(arch), get_model(arch, device="cpu")
    got = dict(named_leaves(sharding.cache_specs(
        tm, tm.make_cache(4, 16, device="meta"), MESH, batch=4)))
    want = {path_str(p): s for p, s in jax.tree_util.tree_leaves_with_path(
        jax_sharding.cache_specs(jm, jm.make_cache(4, 16, abstract=True),
                                 MESH, batch=4),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    assert set(got) == set(want)
    diff = {k: (tuple(want[k]), tuple(v), v.parts) for k, v in got.items()
            if tuple(v) != tuple(want[k]) or v.parts}
    cfg = tm.cfg
    expect = {
        ZAMBA: {"mamba.conv": ((None, "data", None, "model"),) * 2 + (
            ((cfg.mamba_width, 2), (2 * cfg.ssm_state, 1)),)},
        XLSTM: {"mlstm.conv": ((None, "data", None, "model"),
                               (None, "data", None, None), None)},
        WHISPER: {}}[arch]
    assert diff == expect


@pytest.mark.parametrize("arch,extra", [(ZAMBA, {}), (XLSTM, {}),
                                        (XLSTM, {"d_model": 96})],
                         ids=["zamba", "xlstm", "xlstm-split"])
def test_sharded_init_keeps_each_ranks_ssm_heads(arch, extra):
    """``init_params`` under a plan for the recurrent families: the ranks'
    shards of every leaf, put back together per its spec (uneven parts
    too), are the one-device draw."""
    single = get_smoke_model(arch, device="cpu", **extra)
    one = dict(named_leaves(single.init_params(seed=4)))
    specs = dict(named_leaves(sharding.config_param_specs(single.cfg, 2)))
    ranks = []
    for r in range(2):
        plan = sharding.serving_plan(MESH, rank=r)
        model = get_smoke_model(arch, device="cpu", plan=plan, **extra)
        ranks.append(dict(named_leaves(model.init_params(seed=4))))
    for path, full in one.items():
        for r in range(2):
            plan = sharding.serving_plan(MESH, rank=r)
            assert torch.equal(ranks[r][path],
                               plan.shard(full, specs[path])), (path, r)


def test_zamba_lora_delta_spec_names_the_shared_block():
    """A merged LoRA delta on zamba targets its shared block: its spec is
    ``shared_attn.attn.*``'s."""
    cfg = get_smoke_model(ZAMBA, device="cpu").cfg
    specs = dict(named_leaves(sharding.config_param_specs(cfg, 2)))
    for name in TARGETS:
        assert sharding.lora_delta_spec(cfg, name, 2) == \
            specs[f"shared_attn.attn.{name}"]


def test_whisper_specs_validate_and_the_tp_checks_of_the_families():
    """Whisper's specs divide its full shapes; ``check_tp`` accepts
    zamba2-2.7b and xlstm-1.3b at 2 and raises where Mamba2's heads do not
    split (ROADMAP Queue 1, item 12); the xLSTM's 4 heads split unevenly
    over 8 ranks (one head on each of ranks 0, 2, 4 and 6), and its specs
    place every leaf."""
    from repro_torch.models import encdec
    cfg = get_model(WHISPER, device="cpu").cfg
    assert sharding.validate_specs(sharding.config_param_specs(cfg, 2),
                                   encdec.param_specs(cfg), MESH) == []
    for arch in (ZAMBA, XLSTM):
        full = get_model(arch, device="cpu").cfg
        sharding.check_tp(full, 2)
        assert sharding.validate_specs(
            sharding.config_param_specs(full, 2),
            transformer.param_specs(full), MESH) == []
    with pytest.raises(ValueError, match="80 Mamba2 heads.*item 12"):
        sharding.check_tp(get_model(ZAMBA, device="cpu").cfg.replace(
            n_heads=64, n_kv_heads=64), 32)
    xlstm = get_model(XLSTM, device="cpu").cfg
    sharding.check_tp(xlstm, 8)
    assert [b - a for a, b in sharding.head_split(xlstm, 8).q] == \
        [1, 0, 1, 0, 1, 0, 1, 0]
    assert sharding.validate_specs(
        sharding.config_param_specs(xlstm, 8),
        transformer.param_specs(xlstm), ServingMesh(1, 8)) == []


# ---------------------------------------------------------------------------
# training's specs (ROADMAP Queue 1, item 9) against the reference's
# ---------------------------------------------------------------------------

GRID = ServingMesh(2, 2)
DENSE = "llama3-8b"


def _train_diffs(jm, tm, mesh, **kw) -> dict:
    """{JAX path: (JAX's spec, the port's)} of ``param_specs(**kw)``."""
    jspecs = jax.tree_util.tree_leaves_with_path(
        jax_sharding.param_specs(jm, mesh, **kw),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    tspecs = dict(named_leaves(sharding.param_specs(tm, mesh, **kw)))
    lengths = group_lengths(tm.param_specs())
    out = {}
    for p, spec in jspecs:
        path = path_str(p)
        names = port_names(path, lengths)
        want = tuple(spec)[1:] if names != [path] else tuple(spec)
        got = {tuple(tspecs[n]) for n in names}
        assert len(got) == 1, path
        got = got.pop()
        want = want + (None,) * (len(got) - len(want))
        if got != want:
            out[path] = (want, got)
    return out


TRAIN_DIFFS = {(DENSE, "smoke"): ONE_KV_DIFFS, (DENSE, "full"): ATTN_DIFFS,
               (PHI, "smoke"): MOE_DIFFS["smoke"],
               (PHI, "full"): MOE_DIFFS["full"],
               (DSV3, "smoke"): MLA_SMOKE_DIFFS, (DSV3, "full"): MLA_FULL_DIFFS}


def _pair_at(arch, size):
    if size == "smoke":
        return (jax_smoke(arch, n_layers=2),
                get_smoke_model(arch, device="cpu", n_layers=2))
    return jax_model(arch), get_model(arch, device="cpu")


@pytest.mark.parametrize("arch,size", sorted(TRAIN_DIFFS))
def test_fsdp_and_fsdp2d_param_specs_against_jax(arch, size):
    """Over (data 2, model 2).  ``fsdp=True``: the leaves that differ are
    exactly those whose 'model' placement differs at tp = 2 (the listed
    role-based placements), each with 'data' where the reference's ZeRO-3
    rule puts it beside the port's 'model' dimension: the norms on their
    only axis (JAX: 'model' there), wk / wv / wo and the shared expert on
    the dimension 'model' leaves free, the router on its expert axis.
    ``mode='fsdp2d'``: identical to the reference's, leaf for leaf."""
    jm, tm = _pair_at(arch, size)
    diffs = _train_diffs(jm, tm, GRID, fsdp=True)
    assert set(diffs) == set(TRAIN_DIFFS[(arch, size)])
    for path, (want, got) in diffs.items():
        assert "data" in got, path
        if path.endswith("norm"):
            assert (want, got) == (("model",), ("data",))
    assert _train_diffs(jm, tm, GRID, mode="fsdp2d") == {}


def test_fsdp_rule_skips_mla_and_the_model_dimension():
    """MLA's a-side stays replicated and its b-side takes no 'data'; a
    dimension 'model' holds never takes 'data'; the rank's pieces put
    back together give the leaf (``assemble``)."""
    cfg = get_model(DSV3, device="cpu").cfg
    specs = dict(named_leaves(sharding.config_param_specs(
        cfg, 2, fsdp=True, data=2)))
    for leaf in ("wq_a", "wkv_a", "q_a_norm", "kv_a_norm"):
        assert specs[f"layers.0.attn.{leaf}"] == P(*[None] * len(
            specs[f"layers.0.attn.{leaf}"]))
    assert specs["layers.0.attn.wq_b"] == P(None, "model")
    assert specs["layers.0.attn.wkv_b"] == P(None, "model")
    assert specs["layers.0.moe.experts.w_gate"] == P("model", None, "data")
    small = get_smoke_model(DENSE, device="cpu", n_layers=2)
    for mode, fsdp in (("tp", True), ("fsdp2d", False)):
        tspecs = dict(named_leaves(sharding.param_specs(small, GRID, fsdp=fsdp,
                                                        mode=mode)))
        plans = [sharding.training_plan(GRID, rank=r % 2, data_rank=r // 2,
                                        fsdp=fsdp, mode=mode) for r in range(4)]
        for path, leaf in named_leaves(transformer.param_specs(small.cfg)):
            full = torch.randn(tuple(leaf.shape))
            pieces = [pl.shard(full, tspecs[path]) for pl in plans]
            assert torch.equal(sharding.assemble(pieces, tspecs[path],
                                                 plans[0]), full), path


def test_opt_state_specs_against_jax():
    """``m`` and ``v`` mirror the parameters' specs as in the reference; a
    factored second moment's ``row`` and ``col`` keep the parameter's
    entries on the axes they keep, where the reference replicates them
    (``P()``: it has no spec of their rank to mirror)."""
    from repro.train import optimizer as jopt
    from repro_torch.train import optimizer as topt
    jm, tm = _pair_at(DENSE, "smoke")
    kw = dict(factored=True, min_factored_size=16)
    jp = jm.init_params(jax.random.PRNGKey(0))
    jstate = jopt.init_opt_state(jp, jopt.OptimizerConfig(**kw))
    tstate = topt.init_opt_state(tm.param_specs(), topt.OptimizerConfig(**kw))
    jp_specs = jax_sharding.param_specs(jm, GRID, fsdp=True)
    tp_specs = sharding.param_specs(tm, GRID, fsdp=True)
    jo = jax_sharding.opt_state_specs(jp_specs, GRID, opt_state=jstate)
    to = sharding.opt_state_specs(tp_specs, GRID, opt_state=tstate)
    assert jo["step"] == to["step"] == P()
    flat_p = dict(named_leaves(tp_specs))
    assert dict(named_leaves(to["m"])) == flat_p
    for path, spec in named_leaves(to["v"]):
        base, _, part = path.rpartition(".")
        if part == "row":
            assert spec == P(*tuple(flat_p[base])[:-1]), path
        elif part == "col":
            assert spec == P(*(tuple(flat_p[base])[:-2]
                               + tuple(flat_p[base])[-1:])), path
        else:
            assert spec == flat_p[path], path
    factored = [p for p, _ in named_leaves(to["v"]) if p.endswith(".row")]
    assert factored
    # the reference: m mirrors, factored rows and columns replicated
    jleaves = jax.tree_util.tree_leaves_with_path(
        jo["v"], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert {path_str(p) for p, s in jleaves if tuple(s) == ()} >= {
        "blocks.attn.wq.row", "blocks.attn.wq.col"}
    assert jax.tree_util.tree_structure(
        jo["m"], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    ) == jax.tree_util.tree_structure(
        jp_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_batch_specs_match_jax(seq_parallel):
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "labels": np.zeros((8, 16), np.int32),
             "odd": np.zeros((3, 5), np.int32)}
    want = jax_sharding.batch_specs(batch, GRID, seq_parallel=seq_parallel)
    got = sharding.batch_specs(batch, GRID, seq_parallel=seq_parallel)
    assert {k: tuple(v) for k, v in want.items()} == {
        k: tuple(v) for k, v in got.items()}


@pytest.mark.parametrize("arch", [DENSE, DSV3])
def test_prefer_seq_cache_specs_match_jax_and_models_refuse(arch):
    """``cache_specs(prefer_seq=True)``: 'model' on an attention cache's
    sequence axis (MLA's latent too), the batch over 'data', as the
    reference; a model built under a plan that prefers it decodes over
    the split (``tests/test_torch_prefer_seq.py``), but a paged pool over
    it raises naming item 10."""
    jm, tm = _pair_at(arch, "smoke")
    jcache = jm.make_cache(4, 32, abstract=True)
    tcache = tm.make_cache(4, 32, device="meta")
    for mesh in (MESH, GRID):
        want = jax_sharding.cache_specs(jm, jcache, mesh, 4, prefer_seq=True)
        got = sharding.cache_specs(tm, tcache, mesh, 4, prefer_seq=True)
        jl = {path_str(p): tuple(s) for p, s in jax.tree_util.
              tree_leaves_with_path(want, is_leaf=lambda x: isinstance(
                  x, jax.sharding.PartitionSpec))}
        tl = {p: tuple(s) for p, s in named_leaves(got)}
        assert jl == tl
        assert all(s[2] == "model" for s in tl.values())
    plan = sharding.ShardingPlan(MESH, prefer_seq=True)
    model = get_smoke_model(arch, device="cpu", plan=plan)
    if not model.seq_split:              # MLA: the latent stays whole
        return
    with pytest.raises(NotImplementedError, match="item 10"):
        model.make_paged_cache(4, 8)


@pytest.mark.parametrize("arch", [DENSE, PHI, DSV3])
def test_training_specs_validate_at_16x16(arch):
    """``param_specs(fsdp=True)`` and ``mode='fsdp2d'`` of the full-width
    configs divide every shape over (data 16, model 16), as the
    reference's production mesh."""
    cfg = get_model(arch, device="cpu").cfg
    mesh = ServingMesh(16, 16)
    shapes = transformer.param_specs(cfg)
    for kw in (dict(fsdp=True), dict(mode="fsdp2d")):
        specs = sharding.config_param_specs(cfg, 16, data=16, **kw)
        assert sharding.validate_specs(specs, shapes, mesh) == []
        placed = [s for _, s in named_leaves(specs)
                  if any(e is not None for e in s)]
        assert placed


# ---------------------------------------------------------------------------
# heads the model axis does not divide (ROADMAP Queue 1, item 12)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,tp,want", [
    ("smollm-135m", 2, [(6, 2), (3, 1)]),
    ("smollm-135m", 4, [(2, 1), (1, 1), (3, 1), (3, 1)]),
    ("smollm-135m", 16, [(1, 1)] * 3 + [(0, 0)] * 3 + [(1, 1)] * 3
     + [(0, 0)] * 2 + [(1, 1)] * 3 + [(0, 0)] * 2),
    ("qwen3-14b", 16, [(3, 1), (2, 1)] * 8),
    ("qwen2.5-32b", 16, [(3, 1), (2, 1)] * 8),
    ("gemma-2b", 16, [(1, 1)] * 8 + [(0, 0)] * 8),
    ("xlstm-1.3b", 16, [(1, 1), (0, 0), (0, 0), (0, 0)] * 4),
    ("llama3-8b", 16, [(2, 1)] * 16),
    ("chameleon-34b", 16, [(4, 1)] * 16)],
    ids=lambda x: str(x) if not isinstance(x, list) else "heads")
def test_head_split_takes_kv_heads_first_and_rank_0_the_most(arch, tp, want):
    """The KV heads split first (runs of whole query groups, or blocks of
    ranks per head, the larger first), then each head's query heads over
    its block; the rank's configuration holds its counts, rank 0 the
    most at the dry run's model axis of 16 (not always: at 9 / 3 over 4,
    ranks 2 and 3 hold 3), and where the axis divides the heads the split
    is even."""
    cfg = get_model(arch, device="cpu").cfg
    split = sharding.head_split(cfg, tp)
    got = [(b - a, d - c) for (a, b), (c, d) in zip(split.q, split.kv)]
    assert got == want
    assert sum(q for q, _ in got) == cfg.n_heads
    if tp == 16:                 # the dry run reckons rank 0: the busiest
        assert got[0][0] == max(q for q, _ in got)
    even = cfg.n_heads % tp == 0 and (cfg.n_kv_heads % tp == 0
                                      or tp % cfg.n_kv_heads == 0)
    assert split.even == even
    for r in (0, tp - 1):
        local = sharding.local_config(cfg, tp, r)
        assert (local.n_heads, local.n_kv_heads) == got[r]
        assert local.head_first == split.q[r][0]


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-14b", "gemma-2b",
                                  "qwen2.5-32b", "xlstm-1.3b"])
def test_uneven_heads_place_every_leaf_at_16(arch):
    """At (16, 16) the five models whose heads the axis does not divide
    place every parameter and cache leaf: the ranks' pieces validate, and
    each rank's piece is the shape its model allocates."""
    cfg = get_model(arch, device="cpu").cfg
    mesh = ServingMesh(1, 16)
    specs = sharding.config_param_specs(cfg, 16)
    shapes = transformer.param_specs(cfg)
    assert sharding.validate_specs(specs, shapes, mesh) == []
    specs = dict(named_leaves(specs))
    for r in (0, 1, 15):
        local = dict(named_leaves(transformer.param_specs(
            sharding.local_config(cfg, 16, r))))
        for path, t in named_leaves(shapes):
            spec = specs[path]
            shape = list(t.shape)
            if spec.model_dim is not None:
                shape[spec.model_dim] = sharding.piece_size(
                    spec, shape[spec.model_dim], 16, r)
            assert tuple(shape) == tuple(local[path].shape), (path, r)


def test_uneven_pieces_put_back_together_and_fill_the_arena():
    """Smoke smollm with 9 / 3 heads at tp = 2 and 4: every rank's piece
    of one draw put back together (``assemble``) is the one-device leaf,
    and the paged arena's spec cuts the global arena to each rank pool's."""
    from repro_torch.runtime.kv_pool import PagedKVCachePool
    cfg = get_smoke_model("smollm-135m", device="cpu", n_layers=2, n_heads=9,
                          n_kv_heads=3).cfg
    one = dict(named_leaves(get_model(cfg, device="cpu").init_params(5)))
    for tp in (2, 4):
        mesh = ServingMesh(1, tp)
        ranks = [get_model(cfg, device="cpu", plan=sharding.serving_plan(
            mesh, rank=r)) for r in range(tp)]
        pieces = [dict(named_leaves(m.init_params(5))) for m in ranks]
        specs = dict(named_leaves(sharding.config_param_specs(cfg, tp)))
        for path, full in one.items():
            got = sharding.assemble([p[path] for p in pieces], specs[path],
                                    ranks[0].plan)
            assert torch.equal(got, full), (path, tp)
        full = transformer.make_paged_cache(cfg, 9, 8, device="meta")
        arena = sharding.paged_cache_specs(full, mesh, cfg)
        for r, m in enumerate(ranks):
            pool = PagedKVCachePool(m, 2, 16, page_size=8, n_pages=9)
            for k, t in full.items():
                shape = list(t.shape)
                spec = arena[k]
                shape[spec.model_dim] = sharding.piece_size(
                    spec, shape[spec.model_dim], tp, r)
                assert tuple(shape) == tuple(pool.cache[k].shape), (k, r)


@pytest.mark.parametrize("replace,tp,match", [
    ({"ssm_heads": 6}, 4, "Mamba2 heads"),
    ({"d_ff": 130}, 4, "d_ff 130"),
    ({"n_experts": 6}, 4, "6 experts")])
def test_what_check_tp_still_refuses_names_item_12(replace, tp, match):
    arch = ("zamba2-2.7b" if "ssm_heads" in replace else
            PHI if "n_experts" in replace else "llama3-8b")
    cfg = get_smoke_model(arch, device="cpu").cfg.replace(**replace)
    with pytest.raises(ValueError, match=match + ".*item 12"):
        sharding.check_tp(cfg, tp)


@pytest.mark.parametrize("arch,extra,tp", [
    ("smollm-135m", {"n_heads": 9, "n_kv_heads": 3}, 2),
    ("xlstm-1.3b", {}, 8)], ids=["smollm-9-3", "xlstm"])
def test_the_divergence_guard_leaves_out_only_a_cache_leafs_heads(arch, extra,
                                                                   tp):
    """The divergence guard's digest of every rank's cache where the
    heads split unevenly (each rank holds other counts of heads; the
    smoke xlstm's 4 heads at tp = 8 leave ranks without one) is the same
    on every rank, as an object and as an op's argument (a registered
    tree), and tells a cache of another batch (or, for attention, length)
    apart."""
    from repro_torch.distributed.group import (MirrorDict, _digest,
                                               _digest_args)
    cfg = get_smoke_model(arch, device="cpu", **extra).cfg
    ranks = [get_model(cfg, device="cpu", plan=sharding.serving_plan(
        ServingMesh(1, tp), rank=r)) for r in range(tp)]
    assert len({m.local_cfg.n_heads for m in ranks}) > 1
    seen = {_digest(m.make_cache(2, 16)) for m in ranks}
    assert len(seen) == 1
    assert len({repr(_digest_args([MirrorDict(m.make_cache(2, 16))]))
                for m in ranks}) == 1
    assert _digest(ranks[-1].make_cache(1, 16)) not in seen
    if arch == "smollm-135m":
        assert _digest(ranks[-1].make_cache(2, 32)) not in seen
