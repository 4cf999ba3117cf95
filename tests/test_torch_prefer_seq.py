"""Decode over a cache split by sequence (a plan's ``prefer_seq``, the
reference dry run's flash-decoding default), on the CPU.

  * the plain versions of ``decode_attention_slice`` (one rank's rows,
    with its log-sum-exp) and ``decode_merge_ranks`` (the ranks' results
    merged in rank order), over 1, 2 and 4 slices with empty ones,
    reproduce the JAX package's ``decode_attention_ref`` over all rows in
    fp32 within 2e-5;
  * their ``meta`` branches allocate what a card call allocates (the
    split-KV scratch), so the dry run's reckoning holds it;
  * a rank's cache under the plan holds every KV head over its share of
    the positions (MLA's latent and the recurrent states as without it);
  * a decode step traced on ``meta`` at tp = 4 records the reckoned
    collectives (two ``all_gather`` per layer beside the plan's
    ``all_reduce``);
  * pools, engines, suffix prefills and the paged step refuse the split,
    naming ROADMAP item 10.

The spawned tp = 2 decode against the JAX ``decode_step`` is in
``tests/test_torch_tp.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import dry, sharding  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (n_splits,  # noqa: E402
                                                  split_rows)
from repro_torch.models.registry import get_smoke_model  # noqa: E402

TOL = 2e-5
LENGTHS = [0, 1, 37, 64, 65, 100, 127, 128]


def _case(H, KV, d, T, seed=0):
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, d)).astype(np.float32)
    return q, k, v, np.asarray(LENGTHS, np.int32)


def _split(q, k, v, lengths, R):
    """Each of R ranks' (o, lse) over its rows, then the merge."""
    T = k.shape[2]
    Tr = T // R
    q, k, v = (torch.as_tensor(x) for x in (q, k, v))
    ln = torch.as_tensor(lengths)
    outs, lses, empty = [], [], True
    for r in range(R):
        lr = (ln - r * Tr).clamp(0, Tr)
        o, lse = ops.decode_attention_slice(q, k[:, :, r * Tr:(r + 1) * Tr],
                                            v[:, :, r * Tr:(r + 1) * Tr], lr)
        assert o.dtype == lse.dtype == torch.float32
        none = lr == 0
        empty &= bool((o[none] == 0).all()) and bool(
            torch.isneginf(lse[none]).all())
        outs.append(o)
        lses.append(lse)
    merged = ops.decode_merge_ranks(torch.stack(outs), torch.stack(lses),
                                    torch.float32)
    return merged, empty


@pytest.mark.parametrize("heads", [(4, 4, 64), (8, 2, 64), (16, 2, 128)],
                         ids=["G1", "G4", "G8"])
@pytest.mark.parametrize("R", [1, 2, 4])
def test_slices_merged_match_the_jax_decode_ref(heads, R):
    """Over R slices (some sequences with no rows in some slices) the
    merged output equals the JAX plain version over all rows; a sequence
    of length 0 gives zeros (the CUDA kernel's rule), and a slice with no
    rows of a sequence gives zeros and -inf."""
    from repro.kernels.ref import decode_attention_ref as jax_ref
    H, KV, d = heads
    q, k, v, lengths = _case(H, KV, d, 128, seed=R)
    merged, empty = _split(q, k, v, lengths, R)
    want = np.asarray(jax_ref(q, k, v, lengths))
    live = lengths > 0
    got = merged.numpy()
    assert np.abs(got[live] - want[live]).max() <= TOL * max(
        1.0, np.abs(want).max())
    assert (got[~live] == 0).all()
    assert empty


def test_slice_lse_is_the_log_sum_exp_of_its_scores():
    q, k, v, lengths = _case(8, 2, 64, 64)
    o, lse = ref.decode_attention_slice_ref(*(torch.as_tensor(x) for x in
                                              (q, k, v)), torch.as_tensor(lengths))
    qg = q.reshape(len(lengths), 2, 4, 64)
    s = np.einsum("bkgd,bktd->bkgt", qg, k) / 8.0
    for b, n in enumerate(lengths):
        if n:
            want = np.log(np.exp(s[b, ..., :n]).sum(-1)).reshape(8)
            assert np.abs(lse[b].numpy() - want).max() <= 1e-4


def test_merge_skips_ranks_without_rows_and_keeps_rank_order():
    """A rank with lse = -inf adds nothing; one live rank is returned as
    it is; the bf16 output is the fp32 merge rounded once."""
    rng = np.random.default_rng(3)
    o = torch.as_tensor(rng.standard_normal((3, 2, 4, 64)).astype(np.float32))
    lse = torch.full((3, 2, 4), -np.inf)
    lse[1] = 0.5
    got = ops.decode_merge_ranks(o, lse, torch.float32)
    assert torch.equal(got, o[1])
    lse[2] = 0.5
    half = ops.decode_merge_ranks(o, lse, torch.float32)
    assert torch.allclose(half, (o[1] + o[2]) / 2, atol=1e-6)
    assert torch.equal(ops.decode_merge_ranks(o, lse, torch.bfloat16),
                       half.to(torch.bfloat16))


def test_meta_branches_allocate_the_scratch_a_card_call_holds():
    """On ``meta`` the slice entry allocates the split-KV partials beside
    its fp32 outputs (what the CUDA wrapper allocates), so the dry run's
    live-bytes reckoning holds them."""
    B, H, KV, d, T = 8, 64, 8, 128, 2048
    q = torch.empty((B, H, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, KV, T, d), dtype=torch.bfloat16, device="meta")
    assert split_rows(d) == 64 and n_splits(T, d) == 32
    (o, lse), mem = dry.peak_bytes(
        lambda: ops.decode_attention_slice(q, k, k, T), (q, k))
    parts = B * KV * 32 * (H // KV) * (d + 2) * 4
    assert o.shape == (B, H, d) and o.dtype == torch.float32
    assert lse.shape == (B, H)
    assert mem["peak_above_arguments"] == parts + B * H * d * 4 + B * H * 4
    assert mem["output_bytes"] == B * H * d * 4 + B * H * 4
    out = ops.decode_merge_ranks(torch.empty((16, B, H, d), device="meta"),
                                 torch.empty((16, B, H), device="meta"),
                                 torch.bfloat16)
    assert out.shape == (B, H, d) and out.dtype == torch.bfloat16


def _plan(tp=2, rank=0):
    return sharding.ShardingPlan(sharding.ServingMesh(1, tp), rank=rank,
                                 prefer_seq=True)


@pytest.mark.parametrize("arch,leaf", [
    ("llama3-8b", None), ("phi3.5-moe-42b-a6.6b", None),
    ("zamba2-2.7b", "attn_kv"), ("deepseek-v3-671b", "latent"),
    ("xlstm-1.3b", "recurrent")])
def test_a_ranks_cache_holds_every_kv_head_over_its_positions(arch, leaf):
    extra = {"n_kv_heads": 2, "n_heads": 4} if leaf is None else {}
    one = get_smoke_model(arch, device="cpu", **extra)
    model = get_smoke_model(arch, device="cpu", plan=_plan(), **extra)
    plain = get_smoke_model(arch, device="cpu", plan=dataclasses.replace(
        _plan(), prefer_seq=False), **extra)
    whole = one.make_cache(2, 32, device="meta")
    got = model.make_cache(2, 32, device="meta")
    if leaf in ("latent", "recurrent"):
        assert not model.seq_split
        assert {k: tuple(t.shape) for k, t in _leaves(got)} == {
            k: tuple(t.shape) for k, t in _leaves(
                plain.make_cache(2, 32, device="meta"))}
        return
    assert model.seq_split
    kv, wkv = (c["attn_kv"] if leaf else c for c in (got, whole))
    for name in ("k", "v"):
        L, B, T, KV, hd = wkv[name].shape
        assert tuple(kv[name].shape) == (L, B, T // 2, KV, hd)
    with pytest.raises(ValueError, match="does not split"):
        model.make_cache(2, 33, device="meta")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("kv", [4, 2, 1])
def test_a_decode_step_on_meta_records_the_reckoned_collectives(kv):
    """Smoke llama3-8b (2 layers, 8 query heads) at tp = 4 under
    ``prefer_seq``, traced on ``meta`` with no process group (a
    collective over ``meta`` is recorded, not run): per layer one
    ``all_gather`` of q and the new K/V rows and one of the ranks' (o,
    lse) in fp32, beside 2L + 2 fp32 ``all_reduce``; the slice and merge
    entries run once per layer, the dense decode kernel never."""
    from repro_torch.kernels import meta
    tp, B, L = 4, 3, 2
    model = get_smoke_model("llama3-8b", device="cpu", plan=_plan(tp, 1),
                            n_layers=2, n_heads=8, n_kv_heads=kv)
    cfg = model.cfg
    params = {k: v for k, v in _meta_params(model).items()}
    cache = model.make_cache(B, 64, device="meta")
    seen = []

    class Obs:
        quiet = 0

        def kernel(self, name, inputs):
            seen.append(name)

    obs = Obs()
    meta.add_observer(obs)
    sharding.reset_collective_stats()
    try:
        inputs = {"tokens": torch.empty((B, 1), dtype=torch.int32,
                                        device="meta")}
        model.decode_step(params, cache, inputs, 40)
        # outside counting_meta (a controller's shadows) none is recorded
        assert sharding.collective_stats()["calls"] == 0
        with sharding.counting_meta():
            model.decode_step(params, cache, inputs, 40)
    finally:
        meta.remove_observer(obs)
    stats = sharding.collective_stats()
    H, hd, D, V = cfg.n_heads, cfg.head_dim, cfg.d_model, cfg.vocab_size
    Hr, KVr = H // tp, max(kv // tp, 1)
    assert stats["kinds"] == {"all_reduce": 2 * L + 2, "all_gather": 2 * L}
    assert stats["bytes_by_kind"] == {
        "all_reduce": (1 + 2 * L) * B * D * 4 + B * V * 4,
        "all_gather": L * tp * B * ((Hr + 2 * KVr) * hd * 4 + H * (hd + 1) * 4)}
    assert seen.count("decode_attention_slice") == 2 * L
    assert seen.count("decode_merge_ranks") == 2 * L
    assert "decode_attention" not in seen


def _meta_params(model):
    from repro_torch.launch.dryrun import _rank_leaves
    from repro_torch.models import transformer
    return _rank_leaves(model, transformer.param_specs(model.cfg))


def test_pools_engines_and_suffix_prefills_refuse_the_split():
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.kv_pool import KVCachePool, PagedKVCachePool
    model = get_smoke_model("llama3-8b", device="cpu", plan=_plan(),
                            n_heads=4, n_kv_heads=2)
    for build in (lambda: model.make_paged_cache(4, 8),
                  lambda: PagedKVCachePool(model, 2, 32, plan=model.plan),
                  lambda: KVCachePool(model, 2, 32, plan=model.plan),
                  lambda: Engine(model, {}),
                  lambda: model.prefill_from({}, {"tokens": np.zeros(
                      (1, 4), np.int32)}, {}, 4),
                  lambda: model.decode_step_paged({}, {}, {"tokens": np.zeros(
                      (1, 1), np.int32)}, [3], np.zeros((1, 1), np.int32), 8)):
        with pytest.raises(NotImplementedError, match="item 10"):
            build()


def test_a_chunked_prefill_over_the_split_raises_item_10():
    """The attention block under the split takes a prefill from position
    0 only: a later chunk raises."""
    from repro_torch.models import layers
    cfg = get_smoke_model("llama3-8b", device="cpu", n_heads=4,
                          n_kv_heads=2).cfg
    seq = sharding.SeqShard(0, 2, sharding.head_split(cfg, 2))
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 4, 1, 16))
    cache = {"k": torch.zeros((1, 8, 2, 16)), "v": torch.zeros((1, 8, 2, 16))}
    with pytest.raises(NotImplementedError, match="item 10"):
        layers._seq_split_attention(q, k, k, cache, 4, seq, 0.0)


def test_a_training_plan_takes_no_prefer_seq():
    with pytest.raises(ValueError, match="training plan"):
        sharding.ShardingPlan(sharding.ServingMesh(1, 2), training=True,
                              prefer_seq=True)


def test_the_c_entries_take_what_their_wrappers_pass():
    """``repro_decode_attention_slice`` and ``repro_decode_merge_ranks``
    (compiled only on the card) declare as many arguments as their
    wrappers' ``argtypes``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as wrapper
    src = (_build.CSRC / "decode_attention.cu").read_text()
    for name, argtypes in (
            ("repro_decode_attention_slice", wrapper._SLICE_ARGTYPES),
            ("repro_decode_merge_ranks", wrapper._MERGE_ARGTYPES)):
        head = src.split(f'extern "C" int {name}(')[1].split(")")[0]
        assert head.count(",") + 1 == len(argtypes), name
