"""Sharding plans of the port: tensor parallelism over a torch process
group (the counterpart of ``repro.distributed.sharding``'s serving part).

The JAX package runs one controller over sharded arrays and lets GSPMD
insert the collectives; its placement is a shape heuristic ("largest
divisible axis, ties to the last").  The port runs one process per rank
(``distributed.group``) with explicit collectives, and assigns every
parameter by its ROLE in the Megatron layout:

  * ``wq`` / ``wk`` / ``wv`` (and their biases) and ``w_gate`` / ``w_up``
    split by columns, along heads and ``d_ff``; ``wo`` and ``w_down``
    split by rows, each followed by one ``all_reduce``; norms replicated;
  * ``embed`` and ``lm_head`` vocab-parallel when the vocabulary divides
    by the model axis: the embedding masks the rows a rank does not hold
    and sums over ranks, the head's logits are gathered (an exact sum of
    zero-padded slices); otherwise replicated;
  * fused leaves split per part: ``wqkv`` as q, k and v each by heads,
    ``w_gu`` as gate and up each by ``d_ff``;
  * K/V heads that the model axis does not divide (MQA, the smoke
    configs' single KV head) are not split along ``head_dim`` as the JAX
    package's ``paged_cache_specs`` does: each rank keeps the KV heads its
    slice of query heads reads, so a rank's attention sees G = (H / tp) /
    KV_local query heads per KV head;
  * heads the model axis does not divide (smollm's 9 over 2, gemma's 8
    over 16) split unevenly (:func:`head_split`): the KV heads first, in
    contiguous runs of whole query groups (``KV >= tp``) or each over a
    contiguous block of ranks (``KV < tp``), then each KV head's query
    heads over its block, the larger pieces first; every rank keeps the
    uniform G of the kernels' contract, rank 0 holds the most in every
    cell of the dry run, and a rank may hold none (it adds zeros to the
    output projection's sum).  Where the axis divides, this is the even
    placement above;
  * moe: the experts' stacked leaves over 'model' on the expert axis
    (expert parallelism, as the reference places them): rank ``r``
    holds experts ``[r E / tp, (r + 1) E / tp)``, whole; the router
    replicated (every rank routes every token); the shared experts
    split like a dense MLP.  A moe layer's expert partial and shared
    partial meet the other ranks' in ONE ``all_reduce``;
  * MLA: the a-side (``wq_a``, ``wkv_a`` and their norms) replicated,
    ``wq_b`` / ``wkv_b`` split by their head-major columns, ``wo`` by
    rows.  The latent caches (``c_kv``, ``k_rope`` and their int8
    scales) are replicated: every rank's heads read the whole latent.
    The reference's cache specs split ``kv_lora_rank`` instead, which
    would make ``latent @ wkv_b`` a partial sum over ranks (an
    ``all_reduce`` of ``[B, T, H (dn + dv)]`` per layer per step); a
    replicated latent costs 1,152 bytes per token per layer per rank
    at bf16;
  * zamba's Mamba2 mixer by heads: ``in_proj``'s z, x and dt columns and
    ``conv_w``'s x channels split, its B and C columns whole (every head
    reads them), ``dt_bias`` / ``a_log`` / ``d_skip`` and the gated
    norm's scale by heads, ``out_proj`` by rows; its shared attention
    block as a dense block;
  * the mLSTM by heads, its ``x_inner`` (the first half of ``up_proj``)
    and conv whole: ``wq`` / ``wk`` / ``wv`` contract over all of it, so
    a split would cost an all-gather per block; the sLSTM by heads
    (head-major ``w_in`` columns, ``r``'s blocks), its output gathered
    to the whole row, its post-MLP split where the model axis divides
    its width, else replicated;
  * a norm over a row the model axis cuts (Mamba2's gated norm, the
    mLSTM's and sLSTM's) adds the ranks' sums of squares in one
    ``all_reduce`` (``layers.split_rmsnorm``);
  * whisper: q / k / v by heads, ``wo`` and ``w2`` by rows, ``w1`` by
    columns, the output biases, LayerNorms and ``dec_pos`` replicated,
    the self and cross caches by heads (its ``Model.prefill`` and
    ``decode_step`` serve under a plan; the sequential ``Engine`` takes
    none for enc-dec, as the reference's).

A spec is a :class:`PartitionSpec`, a tuple of ``None`` or an axis name
per dimension as in JAX.  Its ``parts`` say how a ``'model'`` dimension
splits when it is not one even split over the ranks: a sequence of
``(size, groups)`` segments, each cut into ``groups`` equal pieces, of
which rank ``r`` keeps piece ``r * groups // tp`` (``groups < tp``: the
piece is replicated over ``tp / groups`` ranks), or, for heads split
unevenly, ``groups`` a tuple of every rank's ``(start, stop)`` in the
segment (ranks sharing a KV head hold the same range, a rank with no
head an empty one).

The plan's functions keep the JAX names and signatures over a
:class:`ServingMesh` ``(data, model)`` whose ``shape`` and
``axis_names`` read like a JAX mesh's.  A SERVING plan with ``data > 1``
is one rank group per instance: :func:`serving_plan` gives the plan of
one data slice (its instance index and that instance's process group),
as the reference serves an instance on ``Mesh(mesh.devices[i:i + 1])``.

A TRAINING plan (:func:`training_plan`) spans the whole mesh: the batch
splits over 'data' (each data rank takes its rows), the model over
'model' as above, and with ``fsdp=True`` every leaf is also stored cut
over 'data' (ZeRO-3, ``distributed.fsdp``) on the dimension the
reference's rule picks (:func:`param_specs`): the output dimension
first, the contraction dimension last, never a dimension 'model' holds,
none for MLA's ``wq_b`` / ``wkv_b``, and MLA's a-side replicated.
``mode='fsdp2d'`` has no tensor parallelism: each leaf is stored over
the whole (data x model) grid on its largest divisible dimension (else
over 'model' alone) and gathered whole before its layer runs; every
rank computes the whole model on its data rows.  The data axis is
``('data',)`` here: the port has no 'pod' axis (the dry run's
multi-pod mesh folds it into data, ``launch.mesh``).

A LoRA adapter bank splits as its targets do (:func:`adapter_bank_specs`):
``b`` of ``wq`` / ``wk`` / ``wv`` by the target's columns (the rank's
heads), ``a`` of ``wo`` by the target's rows; the other factor is
replicated.  A merged delta ``A @ B`` takes its target's spec
(:func:`lora_delta_spec`).

At run time :func:`use_plan` scopes a plan over a model call (the
counterpart of JAX's ``use_kernel_mesh``); :func:`all_reduce`,
:func:`embed_lookup` and :func:`gather_vocab` are the layers'
collectives, and :func:`gather_columns` the sLSTM's; no-ops without a
plan.  They sum in fp32 (gloo on one card
takes bf16, but a bf16 sum would round each partial twice).  Each has
its adjoint for training (Megatron's f and g): :func:`all_reduce` sums
forward and is the identity backward; :func:`copy_to_model`, placed
where a replicated activation or leaf enters work split over 'model'
(q / k / v, gate / up, the LM head, MLA's b-side, the moe gates, the
recurrent mixers' inputs, whisper's encoder output at every
cross-attention), is the identity forward and sums backward;
:func:`sum_grad_columns` sums a replicated weight's gradient where it
feeds split work through an input every rank holds (Mamba2's B / C
columns, the mLSTM's ``x_inner`` columns and conv); :func:`sum_grad_kv`
sums a KV head's projections' gradients over the ranks that share the
head (:attr:`HeadSplit.shared`, the plan's ``kv_group``); a lookup or a
gather's backward takes the rank's slice.  Under a ``prefer_seq`` plan
:func:`seq_shard` gives the attention its sequence-split layout and
:func:`gather_model` is its ``all_gather`` over the model axis.  :func:`vocab_cross_entropy` is the
loss over a vocab-parallel head without gathering its logits: each
rank's max, then its sum of exponentials and its target logits, reduced
as ``[B, S]`` floats.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import time
from typing import Any, Optional

import torch

from repro_torch.models.config import ModelConfig, RankConfig
from repro_torch.utils import map_with_path, named_leaves

MODEL = "model"
DATA = "data"


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """The serving mesh: ``data`` instances of ``model`` ranks each
    (``model > 1``: one rank group per instance)."""
    data: int = 1
    model: int = 1

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"mesh axes must be >= 1, got {self}")

    @property
    def shape(self) -> dict:
        return {DATA: self.data, MODEL: self.model}

    @property
    def axis_names(self) -> tuple:
        return (DATA, MODEL)

    @property
    def size(self) -> int:
        return self.data * self.model


class PartitionSpec(tuple):
    """``P(None, 'model')``: one entry per dimension, as JAX's.  ``parts``
    describes an uneven ``'model'`` dimension (see the module doc)."""

    def __new__(cls, *entries, parts: Optional[tuple] = None):
        spec = super().__new__(cls, entries)
        spec.parts = None if parts is None else tuple(
            (int(s), _groups(g)) for s, g in parts)
        return spec

    def __repr__(self) -> str:
        inner = ", ".join(repr(e) for e in self)
        return f"P({inner}" + (f", parts={self.parts})" if self.parts else ")")

    def __eq__(self, other) -> bool:
        return (tuple(self) == tuple(other)
                and getattr(self, "parts", None) == getattr(other, "parts", None))

    def __hash__(self) -> int:
        return hash((tuple(self), self.parts))

    @property
    def model_dim(self) -> Optional[int]:
        """The dimension over the model axis (None: replicated over it)."""
        dims = [d for d, e in enumerate(self) if e == MODEL]
        if len(dims) > 1:
            raise ValueError(f"{self}: more than one dimension over 'model'")
        return dims[0] if dims else None


P = PartitionSpec


def _groups(g):
    """A segment's pieces: an int, or every rank's ``(start, stop)``."""
    if isinstance(g, (tuple, list)):
        return tuple((int(a), int(b)) for a, b in g)
    return int(g)


def _piece(seg: int, groups, tp: int, rank: int) -> tuple:
    """``(offset, width)`` of rank ``rank``'s piece of a segment."""
    if isinstance(groups, tuple):
        a, b = groups[rank]
        return a, b - a
    width = seg // groups
    return (rank * groups // tp) * width, width


def piece_size(spec: PartitionSpec, size: int, tp: int, rank: int) -> int:
    """The size of rank ``rank``'s piece of a ``size`` dimension that
    ``spec`` puts over 'model' (of ``tp`` ranks)."""
    return sum(_piece(seg, g, tp, rank)[1]
               for seg, g in _segments(spec, size, tp))


def piece_weights(spec: PartitionSpec, tp: int, rank: int) -> list:
    """``[(width, weight)]`` per segment of rank ``rank``'s piece of the
    'model' dimension: ``weight`` is one over the ranks holding that same
    piece, so a sum over the ranks counts each element once."""
    out = []
    for seg, g in spec.parts or ():
        mine = _piece(seg, g, tp, rank)
        holders = sum(_piece(seg, g, tp, r) == mine for r in range(tp))
        out.append((mine[1], 1.0 / holders))
    return out


def _replicated(ndim: int) -> PartitionSpec:
    return P(*[None] * ndim)


def _on(ndim: int, dim: int, parts=None) -> PartitionSpec:
    entries = [None] * ndim
    entries[dim] = MODEL
    return P(*entries, parts=parts)


# ---------------------------------------------------------------------------
# what tensor parallelism serves
# ---------------------------------------------------------------------------

ITEM_12 = "ROADMAP Queue 1, item 12"


def _sizes(n: int, parts: int) -> list:
    """``n`` cut into ``parts`` contiguous pieces, the larger first."""
    q, r = divmod(n, parts)
    return [q + 1] * r + [q] * (parts - r)


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """The query and KV heads of every rank: ``q[r]`` and ``kv[r]`` are
    rank ``r``'s ``[first, stop)`` (:func:`head_split`)."""
    n_heads: int
    n_kv: int
    q: tuple
    kv: tuple

    @property
    def tp(self) -> int:
        return len(self.q)

    @property
    def even(self) -> bool:
        """True where the model axis divides the heads: every rank holds
        ``H / tp`` query heads and the KV heads split evenly or are kept
        by blocks of ``tp / KV`` ranks (the even specs)."""
        tp = self.tp
        return self.n_heads % tp == 0 and (self.n_kv % tp == 0
                                           or tp % self.n_kv == 0)

    def holders(self, j: int) -> tuple:
        """The ranks holding KV head ``j``."""
        return tuple(r for r, (a, b) in enumerate(self.kv) if a <= j < b)

    @property
    def kv_whole(self) -> bool:
        """True when every rank holds every KV head (one KV head, a query
        head of it on every rank)."""
        return self.tp > 1 and all(k == (0, self.n_kv) for k in self.kv)

    @property
    def shared(self) -> tuple:
        """``(head, holders)`` of each KV head that several ranks hold,
        but not all of them (each rank's K/V gradient of it is the partial
        of its own query heads)."""
        out = []
        for j in range(self.n_kv):
            ranks = self.holders(j)
            if 1 < len(ranks) < self.tp:
                out.append((j, ranks))
        return tuple(out)


@functools.lru_cache(maxsize=None)
def _head_split(H: int, KV: int, tp: int) -> HeadSplit:
    G = H // KV
    q, kv = [], []
    if KV >= tp:
        first = 0
        for n in _sizes(KV, tp):
            q.append((first * G, (first + n) * G))
            kv.append((first, first + n))
            first += n
    else:
        for j, block in enumerate(_sizes(tp, KV)):
            first = j * G
            for n in _sizes(G, block):
                q.append((first, first + n))
                kv.append((j, j + 1) if n else (j, j))
                first += n
    return HeadSplit(H, KV, tuple(q), tuple(kv))


def head_split(cfg: ModelConfig, tp: int) -> HeadSplit:
    """Which heads each of ``tp`` ranks holds.  The KV heads split first:
    with ``KV >= tp`` each rank takes a contiguous run of ceil or floor
    ``KV / tp`` whole KV groups (G = H / KV query heads each), the larger
    runs first; with ``KV < tp`` each KV head goes to a contiguous block
    of ceil or floor ``tp / KV`` ranks, the larger blocks first, and its G
    query heads split over the block, the larger pieces first.  Every
    rank keeps the kernels' uniform G; a rank may hold no head.  Where
    the model axis divides the heads this is the even placement.  (The
    reference's GSPMD cuts the flattened head axis instead; the port
    keeps whole heads.)"""
    return _head_split(cfg.n_heads, cfg.n_kv_heads, tp)


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Raise for counts the model axis does not divide and the port does
    not split unevenly: MLA's heads, Mamba2's ``ssm_heads``, experts and
    MLP widths (ROADMAP Queue 1, item 12).  Attention and xLSTM heads
    split unevenly where the axis does not divide them
    (:func:`head_split`).  Every family serves under a plan; whisper's
    sequential ``Engine`` takes none (``runtime.engine``)."""
    if tp == 1:
        return
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if cfg.use_mla:
        if H % tp:
            raise ValueError(f"{cfg.name}: {H} query heads of MLA do not "
                             f"split over {tp} ranks: {ITEM_12}")
    elif H < 1 or KV < 1 or H % KV:
        raise ValueError(f"{cfg.name}: {H} query heads do not group over "
                         f"{KV} KV heads")
    if cfg.family == "xlstm":
        return                  # every xLSTM width is heads times a head's
    if cfg.family == "zamba" and cfg.ssm_heads % tp:
        raise ValueError(f"{cfg.name}: {cfg.ssm_heads} Mamba2 heads do not "
                         f"split over {tp} ranks: {ITEM_12}")
    if cfg.family == "moe":
        if cfg.n_experts % tp:
            raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not "
                             f"split over {tp} ranks: {ITEM_12}")
        if cfg.shared_width % tp:
            raise ValueError(f"{cfg.name}: the shared experts' width "
                             f"{cfg.shared_width} does not split over {tp} "
                             f"ranks: {ITEM_12}")
    elif cfg.d_ff % tp:
        raise ValueError(f"{cfg.name}: d_ff {cfg.d_ff} does not split over "
                         f"{tp} ranks: {ITEM_12}")


def kv_groups(cfg: ModelConfig, tp: int) -> int:
    """Pieces the KV heads are cut into where the model axis divides the
    heads: ``tp`` (KV heads split evenly) or ``KV`` (fewer KV heads than
    ranks: one head per rank, shared)."""
    return tp if cfg.n_kv_heads % tp == 0 else cfg.n_kv_heads


def vocab_parallel(cfg: ModelConfig, tp: int) -> bool:
    """Embedding and head split over the vocabulary (else replicated)."""
    return tp > 1 and cfg.vocab_size % tp == 0


def slstm_mlp_split(cfg: ModelConfig, tp: int) -> bool:
    """The sLSTM post-MLP splits by its width (else replicated: every
    rank runs all of it, no collective; the reference's own fallback)."""
    return tp > 1 and cfg.slstm_mlp_width % tp == 0


def local_config(cfg: ModelConfig, tp: int, rank: int) -> ModelConfig:
    """The configuration rank ``rank`` computes with (a
    :class:`RankConfig`): its query heads, the KV heads they read, its
    slice of ``d_ff`` and, vocab-parallel, of the vocabulary.
    ``head_dim`` and ``d_model`` stay, and so do MLA's latent widths.  A
    moe layer keeps the global ``n_experts`` (routing and the capacity
    read it) and each expert's whole width ``moe_d_ff``; the rank's
    expert range and its slice of the shared experts' width are stored
    in their own fields, as are the recurrent mixers' widths: Mamba2's
    ``ssm_heads`` and their channels, the mLSTM and sLSTM heads' widths
    (the mLSTM's ``x_inner`` input stays whole) and the sLSTM post-MLP's
    slice, or all of it where ``tp`` does not divide it."""
    if tp == 1:
        return cfg
    check_tp(cfg, tp)
    if cfg.use_mla:
        per = cfg.n_heads // tp
        q0, q1 = rank * per, (rank + 1) * per
        k0, k1 = 0, cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else 1
    else:
        split = head_split(cfg, tp)
        (q0, q1), (k0, k1) = split.q[rank], split.kv[rank]
    vocab = cfg.vocab_size // tp if vocab_parallel(cfg, tp) else cfg.vocab_size
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    fields.update(n_heads=q1 - q0, n_kv_heads=k1 - k0,
                  d_ff=cfg.d_ff // tp, vocab_size=vocab)
    moe = {}
    if cfg.n_experts:
        per = cfg.n_experts // tp
        fields["moe_d_ff"] = cfg.moe_d_ff or cfg.d_ff
        moe = dict(expert_first=rank * per, n_local_experts=per,
                   shared_d_ff=cfg.shared_width // tp)
    zamba, xlstm = cfg.family == "zamba", cfg.family == "xlstm"
    if zamba:
        fields["ssm_heads"] = cfg.ssm_heads // tp
    mlp = cfg.slstm_mlp_width
    h, H = (q1 - q0, cfg.n_heads) if xlstm else (1, 1)
    widths = dict(
        mamba_d_inner=cfg.mamba_width // (tp if zamba else 1),
        mlstm_d_inner=cfg.mlstm_width * h // H,
        slstm_d=cfg.slstm_width * h // H,
        slstm_d_ff=mlp // tp if xlstm and slstm_mlp_split(cfg, tp) else mlp)
    return RankConfig(**fields, **moe, **widths, first_head=q0,
                      n_heads_total=cfg.n_heads)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardingPlan:
    """Placement for one process.  Serving (``training=False``): the mesh
    of its instance (``data == 1``), this process's rank on the model
    axis, the torch process group the collectives run over (None: specs
    only, no collectives) and the instance (the data slice) the plan
    serves.  Training (:func:`training_plan`): the whole mesh, this
    rank's index on 'data' (``data_rank``), the data-axis group (the
    ranks of its model index in every data slice) and the world group,
    ``fsdp`` and ``mode`` ('tp' or 'fsdp2d').  ``prefer_seq`` (serving
    only; the reference's flash-decoding cache) splits an attention
    cache's sequence axis over the model ranks: a model under it prefills
    from position 0 and decodes over the split (``models.layers``).
    ``kv_group`` (training, a KV head some but not all ranks hold): the
    process group of the ranks that hold this rank's KV head
    (:func:`with_kv_groups`)."""
    mesh: ServingMesh
    fsdp: bool = False
    rank: int = 0
    group: Any = None
    instance: int = 0
    training: bool = False
    mode: str = "tp"
    data_rank: int = 0
    data_group: Any = None
    world_group: Any = None
    prefer_seq: bool = False
    kv_group: Any = None

    def __post_init__(self):
        if self.mode not in ("tp", "fsdp2d"):
            raise ValueError(f"mode must be 'tp' or 'fsdp2d', got {self.mode!r}")
        if not self.training:
            if self.fsdp or self.mode != "tp":
                raise ValueError("FSDP and mode='fsdp2d' place training "
                                 "state: use sharding.training_plan")
            if self.mesh.data != 1:
                raise ValueError(f"a plan serves one data slice, not "
                                 f"{self.mesh}")
        elif self.prefer_seq:
            raise ValueError("prefer_seq places a serving cache; a training "
                             "plan has none")
        if not 0 <= self.rank < self.mesh.model:
            raise ValueError(f"rank {self.rank} outside the model axis "
                             f"{self.mesh.model}")
        if not 0 <= self.data_rank < self.mesh.data:
            raise ValueError(f"data rank {self.data_rank} outside the data "
                             f"axis {self.mesh.data}")

    @property
    def tp(self) -> int:
        """Ranks the model's heads and widths split over (1 under
        ``fsdp2d``, where 'model' only stores)."""
        return 1 if self.mode == "fsdp2d" else self.mesh.model

    @property
    def data(self) -> int:
        return self.mesh.data

    @property
    def world_rank(self) -> int:
        """This rank's index over the (data x model) grid."""
        return self.data_rank * self.mesh.model + self.rank

    @property
    def distributed(self) -> bool:
        """True when a model call under this plan meets other ranks."""
        return self.mesh.size > 1

    def shard(self, tensor: torch.Tensor, spec) -> torch.Tensor:
        """This rank's piece of a full leaf (what JAX's ``named(spec)``
        placement does for one device)."""
        return shard_for_rank(tensor, spec, self)


def serving_plan(mesh: ServingMesh, rank: Optional[int] = None,
                 group=None, instance: Optional[int] = None,
                 prefer_seq: bool = False) -> ShardingPlan:
    """Tensor-parallel serving plan of one instance: TP over 'model', no
    FSDP, over the slice ``ServingMesh(1, model)`` of ``mesh`` (data > 1:
    instance ``instance`` of ``mesh.data``).  ``rank``, ``group`` and
    ``instance`` default to this process's (``distributed.group``); a
    plan outside any group places but cannot run a collective.
    ``prefer_seq``: the attention caches split by sequence (see
    :class:`ShardingPlan`)."""
    if rank is None:
        from repro_torch.distributed.group import current_group
        tpg = current_group()
        rank = 0 if tpg is None else tpg.rank
        group = group if tpg is None else tpg.data_group
        if instance is None and tpg is not None:
            instance = tpg.instance
    instance = instance or 0
    if not 0 <= instance < mesh.data:
        raise ValueError(f"instance {instance} outside the data axis "
                         f"{mesh.data}")
    return ShardingPlan(mesh=ServingMesh(1, mesh.model), rank=rank,
                        group=group, instance=instance, prefer_seq=prefer_seq)


def training_plan(mesh: ServingMesh, rank: int = 0, data_rank: int = 0,
                  group=None, data_group=None, world_group=None,
                  fsdp: bool = False, mode: str = "tp") -> ShardingPlan:
    """The plan of one rank of a training mesh: model rank ``rank`` of
    data slice ``data_rank``, with the model-axis, data-axis and world
    groups its collectives run over (``distributed.group.TPGroup.
    training_plan`` fills them in; None: specs only)."""
    return ShardingPlan(mesh=mesh, fsdp=fsdp, rank=rank, group=group,
                        training=True, mode=mode, data_rank=data_rank,
                        data_group=data_group, world_group=world_group)


def with_kv_groups(plan: ShardingPlan, cfg: ModelConfig) -> ShardingPlan:
    """``plan`` with its ``kv_group``: under a training plan whose KV
    heads are shared by some but not all model ranks
    (:attr:`HeadSplit.shared`), one process group per (data slice, such
    KV head) of the ranks that hold that head, made with
    ``dist.new_group`` by every rank in the same order (so every rank
    must call this as it builds its model); the plan itself otherwise, or
    when it has no process group (specs only)."""
    tp = plan.tp
    if (not plan.training or tp == 1 or cfg.use_mla or plan.group is None
            or plan.kv_group is not None):
        return plan
    shared = head_split(cfg, tp).shared
    if not shared:
        return plan
    import torch.distributed as dist
    mine = None
    for i in range(plan.mesh.data):
        for _, ranks in shared:
            group = dist.new_group([i * tp + r for r in ranks])
            if i == plan.data_rank and plan.rank in ranks:
                mine = group
    return dataclasses.replace(plan, kv_group=mine)


# ---------------------------------------------------------------------------
# specs (JAX names and signatures)
# ---------------------------------------------------------------------------

def _head_seg(cfg: ModelConfig, tp: int, size: int, kv: bool = False) -> tuple:
    """One head-major segment of ``size`` over the query (or KV) heads:
    ``(size, tp)`` or ``(size, kv_groups)`` where the model axis divides
    the heads, else every rank's range (:func:`head_split`)."""
    split = head_split(cfg, tp)
    if split.even:
        return (size, kv_groups(cfg, tp) if kv else tp)
    spans, n = (split.kv, split.n_kv) if kv else (split.q, split.n_heads)
    per = size // n
    return (size, tuple((a * per, b * per) for a, b in spans))


def _by_heads(ndim: int, dim: int, size: int, cfg: ModelConfig, tp: int,
              kv: bool = False) -> PartitionSpec:
    """A leaf cut on ``dim`` (of ``size``, head-major) by the rank's query
    heads, or its KV heads (``kv``: replicated where every rank holds
    every KV head)."""
    seg = _head_seg(cfg, tp, size, kv)
    if seg[1] == tp:
        return _on(ndim, dim)
    if kv and (seg[1] == 1 or head_split(cfg, tp).kv_whole):
        return _replicated(ndim)
    return _on(ndim, dim, (seg,))


# MLA's low-rank a-side: every rank computes the whole latent its heads read
_MLA_REPLICATED = ("wq_a", "wkv_a")
# the latent cache leaves of an MLA arena or dense cache (replicated)
LATENT_LEAVES = ("c_kv", "k_rope", "c_kv_scale", "k_rope_scale")


def _mixer_spec(group: str, leaf: str, cfg: ModelConfig,
                tp: int) -> PartitionSpec:
    """A recurrent mixer's leaf (``mamba.N.mixer.*``, ``mlstm.N.mixer.*``,
    ``slstm.N.mixer.*``) by its role: its heads' columns split, whatever
    every head reads whole, the output projection by rows."""
    if group == "mamba":
        di, H, bc = cfg.mamba_width, cfg.ssm_heads, 2 * cfg.ssm_state
        if leaf == "in_proj":              # [D, z | x | B | C | dt]
            return _on(2, 1, ((di, tp), (di, tp), (bc, 1), (H, tp)))
        if leaf == "conv_w":               # [W, x | B | C]
            return _on(2, 1, ((di, tp), (bc, 1)))
        if leaf in ("dt_bias", "a_log", "d_skip", "norm"):
            return _on(1, 0)
        if leaf == "out_proj":
            return _on(2, 0)
    elif group == "mlstm":
        di, H, w = cfg.mlstm_input_width, cfg.n_heads, cfg.mlstm_width
        gates = _head_seg(cfg, tp, H)
        if leaf == "up_proj":              # [D, x_inner (whole) | z]
            return _on(2, 1, ((di, 1), _head_seg(cfg, tp, w)))
        if leaf == "conv_w":
            return _replicated(2)
        if leaf in ("wq", "wk", "wv"):
            return _by_heads(2, 1, w, cfg, tp)
        if leaf == "w_if":                 # [d_inner, input gates | forget]
            return _on(2, 1, (gates, gates))
        if leaf == "b_if":
            return _on(1, 0, (gates, gates))
        if leaf == "norm":
            return _by_heads(1, 0, w, cfg, tp)
        if leaf == "down_proj":
            return _by_heads(2, 0, w, cfg, tp)
    elif group == "slstm":
        split, w = slstm_mlp_split(cfg, tp), cfg.slstm_width
        if leaf == "w_in":                 # head-major columns
            return _by_heads(2, 1, 4 * w, cfg, tp)
        if leaf == "b":
            return _by_heads(1, 0, 4 * w, cfg, tp)
        if leaf == "norm":
            return _by_heads(1, 0, w, cfg, tp)
        if leaf == "r":                    # [H, dh, 4 dh], block-diagonal
            return _by_heads(3, 0, cfg.n_heads, cfg, tp)
        if leaf in ("w_gate", "w_up"):
            return _on(2, 1) if split else _replicated(2)
        if leaf == "w_down":
            return _on(2, 0) if split else _replicated(2)
    raise NotImplementedError(f"{group}.mixer.{leaf}: no tensor-parallel role")


# whisper's leaves every rank holds whole: the output biases (added once,
# after the all_reduce), the LayerNorms, the decoder positions
_ENCDEC_REPLICATED = ("bo", "b2", "dec_pos", "scale", "bias")


def _param_spec(path: str, shape: tuple, cfg: ModelConfig,
                tp: int) -> PartitionSpec:
    ndim = len(shape)
    parts = path.split(".")
    leaf = parts[-1]
    if tp == 1:
        return _replicated(ndim)
    if len(parts) > 3 and parts[2] == "mixer":
        return _mixer_spec(parts[0], leaf, cfg, tp)
    if cfg.is_encdec:
        if leaf in _ENCDEC_REPLICATED:
            return _replicated(ndim)
        if leaf == "w1":
            return _on(2, 1)
        if leaf == "b1":
            return _on(1, 0)
        if leaf == "w2":
            return _on(2, 0)
    if "experts" in parts:               # [E, D, F] / [E, F, D]: by expert
        return _on(ndim, 0)
    if leaf == "router" or leaf in _MLA_REPLICATED:
        return _replicated(ndim)
    if leaf in ("wq_b", "wkv_b"):         # head-major columns
        return _on(2, 1)
    if leaf == "embed":
        return _on(2, 0) if vocab_parallel(cfg, tp) else _replicated(2)
    if leaf == "lm_head":
        return _on(2, 1) if vocab_parallel(cfg, tp) else _replicated(2)
    hd, H, KV, F = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    if leaf in ("w_gate", "w_up"):
        return _on(2, 1)
    if leaf == "wq":
        return _by_heads(2, 1, H * hd, cfg, tp)
    if leaf == "bq":
        return _by_heads(1, 0, H * hd, cfg, tp)
    if leaf == "w_down":
        return _on(2, 0)
    if leaf == "wo":
        return _by_heads(2, 0, H * hd, cfg, tp)
    if leaf in ("wk", "wv", "bk", "bv"):
        return _by_heads(ndim, ndim - 1, shape[-1], cfg, tp, kv=True)
    if leaf == "wqkv":
        kv = _head_seg(cfg, tp, KV * hd, kv=True)
        return _on(2, 1, (_head_seg(cfg, tp, H * hd), kv, kv))
    if leaf == "w_gu":
        return _on(2, 1, ((F, tp), (F, tp)))
    if leaf.endswith("norm"):
        return _replicated(ndim)
    raise NotImplementedError(f"{path}: no tensor-parallel role")


def param_specs(model, mesh, fsdp: bool = False, mode: str = "tp"):
    """PartitionSpec tree matching the model's (global) parameter tree:
    ``mode='tp'`` places by role over 'model' (and with ``fsdp`` also over
    'data'); ``mode='fsdp2d'`` stores over the (data x model) grid with no
    tensor parallelism (see the module doc)."""
    return config_param_specs(model.cfg, mesh.shape[MODEL], fsdp=fsdp,
                              mode=mode, data=mesh.shape[DATA])


# MLA's b-side takes no FSDP: its only other dimension is the latent rank
# the products contract over (the reference's rule)
_MLA_NO_FSDP = ("wq_b", "wkv_b")


def _fsdp_spec(path: str, shape: tuple, spec: PartitionSpec, cfg: ModelConfig,
               data: int) -> PartitionSpec:
    """``spec`` with 'data' added by the reference's ZeRO-3 rule
    (``repro.distributed.sharding._choose_param_spec``): the output
    dimension first, then the middle ones, the contraction dimension
    last; a dimension 'model' holds or that 'data' does not divide is
    passed over, and so are MLA's a-side (replicated) and b-side."""
    leaf = path.rsplit(".", 1)[-1]
    if data == 1 or (cfg.use_mla and (leaf in _MLA_NO_FSDP
                                      or leaf in _MLA_REPLICATED
                                      or leaf in ("q_a_norm", "kv_a_norm"))):
        return spec
    ndim = len(shape)
    order = ([ndim - 1] + [d for d in range(ndim) if d < ndim - 2]
             + ([ndim - 2] if ndim >= 2 else []))
    for d in order:
        if spec[d] is None and shape[d] % data == 0 and shape[d] >= data:
            entries = list(spec)
            entries[d] = DATA
            return P(*entries, parts=spec.parts)
    return spec


def _fsdp2d_spec(shape: tuple, data: int, model: int) -> PartitionSpec:
    """The reference's ``mode='fsdp2d'``: the largest dimension the whole
    grid divides (ties to the last) over ``('data', 'model')``, else the
    first dimension 'model' divides over 'model' alone, else replicated."""
    n = data * model
    best, best_size = None, 0
    for d, size in enumerate(shape):
        if size % n == 0 and size >= best_size:
            best, best_size = d, size
    entries = [None] * len(shape)
    if best is not None:
        entries[best] = (DATA, MODEL)
    else:
        for d, size in enumerate(shape):
            if size % model == 0 and size >= model:
                entries[d] = MODEL
                break
    return P(*entries)


def config_param_specs(cfg: ModelConfig, tp: int, fsdp: bool = False,
                       mode: str = "tp", data: int = 1):
    """:func:`param_specs` of a configuration over a (``data``, ``tp``)
    mesh."""
    from repro_torch.models import encdec, transformer
    family = encdec if cfg.is_encdec else transformer
    shapes = family.param_specs(cfg)
    if mode == "fsdp2d":
        return map_with_path(
            lambda path, leaf: _fsdp2d_spec(tuple(leaf.shape), data, tp),
            shapes)
    if mode != "tp":
        raise ValueError(f"mode must be 'tp' or 'fsdp2d', got {mode!r}")
    check_tp(cfg, tp)

    def choose(path, leaf):
        spec = _param_spec(path, tuple(leaf.shape), cfg, tp)
        return _fsdp_spec(path, tuple(leaf.shape), spec, cfg, data) if fsdp \
            else spec

    return map_with_path(choose, shapes)


def plan_param_specs(cfg: ModelConfig, plan: ShardingPlan):
    """The parameter specs a plan places a model's leaves by."""
    return config_param_specs(cfg, plan.mesh.model, fsdp=plan.fsdp,
                              mode=plan.mode, data=plan.mesh.data)


def leaf_param_specs(model, mesh) -> dict:
    """{path -> PartitionSpec} for every parameter leaf (a model under a
    training plan: the plan's FSDP and mode)."""
    plan = getattr(model, "plan", None)
    if plan is not None and plan.training:
        return dict(named_leaves(plan_param_specs(model.cfg, plan)))
    return dict(named_leaves(param_specs(model, mesh)))


def opt_state_specs(p_specs, mesh, factored: bool = False, opt_state=None):
    """Optimizer-state specs: ``m`` and ``v`` mirror the parameters'
    specs.  A factored second moment's ``row`` (the parameter's shape
    without its last axis) and ``col`` (without its second to last) keep
    the parameter's entries on the axes they keep, so each rank holds the
    rows and columns of its own piece; the reference gives both ``P()``
    (replicated), having no spec of their rank to mirror.  ``factored``
    is read from ``opt_state``'s leaves, as the reference does."""
    del mesh, factored
    if opt_state is None:
        return {"m": p_specs, "v": p_specs, "step": P()}
    specs = dict(named_leaves(p_specs))

    def pick(path, leaf):
        for suffix, drop in ((".row", -1), (".col", -2)):
            if path.endswith(suffix) and path[:-len(suffix)] in specs:
                spec = specs[path[:-len(suffix)]]
                entries = list(spec)
                del entries[drop]
                keep = spec.model_dim is not None and spec.model_dim != (
                    len(spec) + drop)
                return P(*entries, parts=spec.parts if keep else None)
        spec = specs.get(path)
        if spec is not None and len(spec) == len(leaf.shape):
            return spec
        return _replicated(len(leaf.shape))

    return {"m": map_with_path(pick, opt_state["m"]),
            "v": map_with_path(pick, opt_state["v"]), "step": P()}


def batch_specs(batch_tree, mesh, seq_parallel: bool = False):
    """A global batch's specs: the batch axis over 'data' where it
    divides, and with ``seq_parallel`` the sequence axis over 'model' (as
    the reference; a sequence-parallel train step is ROADMAP Queue 1,
    item 10)."""
    dp, tp = mesh.shape[DATA], mesh.shape[MODEL]

    def choose(path, leaf):
        shape = tuple(leaf.shape)
        entries = [None] * len(shape)
        if shape and shape[0] % dp == 0 and shape[0] >= dp:
            entries[0] = DATA
        if (seq_parallel and len(shape) >= 2 and shape[1] % tp == 0
                and shape[1] >= tp):
            entries[1] = MODEL
        return P(*entries)

    return map_with_path(choose, batch_tree)


def _state_spec(group: str, leaf: str, ndim: int, cfg: ModelConfig,
                tp: int) -> PartitionSpec:
    """A recurrent state leaf (``[L, B, H, ...]``, or a conv window ``[L,
    B, W-1, channels]``) over 'model': by heads, and a conv window as its
    weight is placed (Mamba2's x channels split, B and C whole; the
    mLSTM's whole)."""
    if leaf != "conv":
        return (_on(ndim, 2) if group == "mamba"
                else _by_heads(ndim, 2, cfg.n_heads, cfg, tp))
    if group == "mamba":
        return _on(ndim, 3, ((cfg.mamba_width, tp), (2 * cfg.ssm_state, 1)))
    return _replicated(ndim)


def cache_head_axis(path: str, ndim: int) -> Optional[int]:
    """The axis of a cache leaf (dense or paged, by its path) that holds
    heads: a K/V leaf's 3 (``[L, B, T, KV, hd]``, ``[L, n_pages,
    page_size, KV, ...]``), a recurrent state's 2 (``[L, B, H, ...]``);
    None for MLA's latent and the conv windows.  Where the heads split
    unevenly (:func:`head_split`) the ranks' leaves differ on it alone."""
    parts = path.split(".")
    if {"mamba", "mlstm", "slstm"} & set(parts):
        return None if parts[-1] == "conv" else 2
    if ndim < 4 or parts[-1] in LATENT_LEAVES:
        return None
    return 3


def cache_specs(model, cache_tree, mesh, batch: int, prefer_seq: bool = False,
                replicate_model: bool = False):
    """Specs of dense caches (leaves ``[L, B, T, KV, hd]``, the GLOBAL
    shapes): the batch axis over 'data' when it divides (as the JAX
    package places it), K/V heads over 'model' as the parameters place
    the heads that fill them (zamba's ``attn_kv``, whisper's ``self_kv``
    and ``cross_kv`` too), MLA's latent leaves replicated over 'model'
    (every rank allocates them whole), the recurrent states (``mamba``,
    ``mlstm``, ``slstm``) by heads and their conv windows as the conv
    weights (:func:`_state_spec`).  ``prefer_seq`` (the reference's
    flash-decoding cache, the default of its dry run's decode cells)
    puts 'model' on an attention cache's sequence axis instead of its
    heads (the recurrent states keep theirs), as the reference does; a
    model under a ``prefer_seq`` plan allocates so (``Model.make_cache``),
    except MLA's latent, which stays whole on every rank."""
    cfg = model.cfg
    tp, dp = mesh.shape[MODEL], mesh.shape[DATA]
    check_tp(cfg, tp)

    def choose(path, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        entries = [None] * ndim
        if ndim >= 2 and shape[1] % dp == 0 and shape[1] >= dp:
            entries[1] = DATA
        group, name = path.split(".")[0], path.rsplit(".", 1)[-1]
        if replicate_model or tp == 1:
            return P(*entries)
        if group in ("mamba", "mlstm", "slstm"):
            spec = _state_spec(group, name, ndim, cfg, tp)
        elif (prefer_seq and ndim >= 3 and entries[2] is None
              and shape[2] % tp == 0 and shape[2] >= tp):
            entries[2] = MODEL
            return P(*entries)
        elif ndim < 4 or name in LATENT_LEAVES:
            return P(*entries)
        else:
            spec = _by_heads(ndim, 3, shape[3], cfg, tp, kv=True)
        return P(*[e or s for e, s in zip(entries, spec)], parts=spec.parts)

    return map_with_path(choose, cache_tree)


def paged_cache_specs(cache_tree, mesh, cfg: ModelConfig):
    """Specs of block-paged arenas (leaves ``[L, n_pages, page_size, KV,
    ...]``, the GLOBAL shapes; int8 scales ``[L, n_pages, page_size,
    KV]``) of a model of configuration ``cfg``: the layer, page and
    in-page axes replicated (the page table is host state), the KV heads
    over 'model' as the rank's attention holds them (:func:`head_split`:
    split, one head per block of ranks, or every head on every rank).
    MLA's latent leaves (``LATENT_LEAVES``) are replicated: every rank's
    pool allocates them whole."""
    tp = mesh.shape[MODEL]

    def choose(path, leaf):
        ndim = leaf.dim()
        if tp == 1 or ndim < 4 or path.rsplit(".", 1)[-1] in LATENT_LEAVES:
            return _replicated(ndim)
        return _by_heads(ndim, 3, leaf.shape[3], cfg, tp, kv=True)

    return map_with_path(choose, cache_tree)


def lora_delta_spec(cfg: ModelConfig, target: str, tp: int) -> PartitionSpec:
    """The spec of a merged LoRA delta ``A @ B`` of one layer's attention
    projection ``target`` (``wq``, ``wk``, ``wv`` or ``wo``, ``[in,
    out]``; zamba's of its shared block): its target's, so that each rank
    adds its shard of the delta to its shard of the weight."""
    from repro_torch.models.adapters import target_dims
    block = "shared_attn" if cfg.family == "zamba" else "layers.0"
    return _param_spec(f"{block}.attn.{target}", target_dims(cfg, target),
                       cfg, tp)


def adapter_bank_specs(cfg: ModelConfig, targets, tp: int) -> dict:
    """Specs of an adapter bank's leaves (``a: [L, N, in, r]``, ``b: [L,
    N, r, out]``, the GLOBAL shapes) per target projection: the factor on
    the target's split side follows the target's spec (``b`` of ``wq`` /
    ``wk`` / ``wv`` by columns, as the rank's heads and KV heads; ``a``
    of ``wo`` by rows), the other factor is replicated.  The layer and
    adapter axes are replicated, so row 0 stays the null adapter on
    every rank."""
    out = {}
    for name in targets:
        spec = lora_delta_spec(cfg, name, tp)
        a, b = _replicated(4), _replicated(4)
        if spec.model_dim == 0:
            a = _on(4, 2, spec.parts)
        elif spec.model_dim == 1:
            b = _on(4, 3, spec.parts)
        out[name] = {"a": a, "b": b}
    return out


def _segments(spec: PartitionSpec, size: int, tp: int) -> tuple:
    parts = spec.parts or ((size, tp),)
    if sum(s for s, _ in parts) != size:
        raise ValueError(f"{spec}: parts cover {sum(s for s, _ in parts)} "
                         f"of {size}")
    return parts


def validate_specs(spec_tree, shape_tree, mesh) -> list:
    """Divisibility of every sharded dimension; returns the violations
    ``(path, dim, size, pieces)``."""
    bad = []
    shapes = dict(named_leaves(shape_tree))
    for path, spec in named_leaves(spec_tree):
        shape = tuple(shapes[path].shape)
        for d, name in enumerate(spec):
            if name is None:
                continue
            if name in (DATA, (DATA, MODEL)):
                n = mesh.shape[DATA] * (1 if name == DATA else mesh.shape[MODEL])
                if shape[d] % n:
                    bad.append((path, d, shape[d], n))
                continue
            for seg, groups in _segments(spec, shape[d], mesh.shape[MODEL]):
                if isinstance(groups, tuple):
                    if (len(groups) != mesh.shape[MODEL]
                            or any(not 0 <= a <= b <= seg for a, b in groups)):
                        bad.append((path, d, seg, groups))
                elif seg % groups:
                    bad.append((path, d, seg, groups))
    return bad


def whole_bytes(spec: PartitionSpec, nbytes: int, tp: int = 1,
                rank: int = 0) -> int:
    """Of rank ``rank``'s ``nbytes`` of a leaf (of ``tp`` ranks), the bytes
    every rank holds alike: all of a replicated leaf, the segments of one
    group (``(size, 1)``: Mamba2's B and C columns, the mLSTM's
    ``x_inner`` half of ``up_proj``) of a split one."""
    if spec.model_dim is None:
        return nbytes
    if not spec.parts:
        return 0
    piece = sum(_piece(seg, g, tp, rank)[1] for seg, g in spec.parts)
    whole = sum(seg for seg, g in spec.parts if g == 1)
    return nbytes * whole // piece if piece else 0


def _even_piece(tensor: torch.Tensor, dim: int, n: int, index: int):
    width = tensor.shape[dim] // n
    return tensor.narrow(dim, index * width, width)


def shard_for_rank(tensor: torch.Tensor, spec: PartitionSpec,
                   plan: ShardingPlan) -> torch.Tensor:
    """This rank's piece of a full leaf (a copy of its own, which never
    keeps the full leaf's storage alive; the leaf itself when the spec
    replicates it): its 'model' piece (by ``parts`` where uneven), then
    under a training plan its 'data' piece, or its piece of the whole
    grid for a ``('data', 'model')`` entry."""
    d = spec.model_dim
    out = tensor
    if d is not None:
        tp, r = plan.mesh.model, plan.rank
        pieces, start = [], 0
        for seg, groups in _segments(spec, tensor.shape[d], tp):
            first, width = _piece(seg, groups, tp, r)
            pieces.append(tensor.narrow(d, start + first, width))
            start += seg
        out = torch.cat(pieces, dim=d) if len(pieces) > 1 else pieces[0]
    for dim, entry in enumerate(spec):
        if entry == DATA and plan.mesh.data > 1:
            out = _even_piece(out, dim, plan.mesh.data, plan.data_rank)
        elif entry == (DATA, MODEL):
            out = _even_piece(out, dim, plan.mesh.size, plan.world_rank)
    if out is tensor:
        return tensor
    return out.clone(memory_format=torch.contiguous_format)


def assemble(pieces: list, spec: PartitionSpec, plan: ShardingPlan):
    """The whole leaf from every rank's piece (``pieces[r]`` is grid rank
    ``r``'s, ``r = data_rank * model + model_rank``): the inverse of
    :func:`shard_for_rank` over ``plan``'s mesh."""
    D, M = plan.mesh.data, plan.mesh.model
    for d, entry in enumerate(spec):
        if entry == (DATA, MODEL):
            return torch.cat(pieces, dim=d)
    for d, entry in enumerate(spec):
        if entry == DATA and D > 1:
            pieces = [torch.cat(pieces[m::M], dim=d) for m in range(M)]
            break
    else:
        pieces = pieces[:M]
    d = spec.model_dim
    if d is None:
        return pieces[0]
    out, segs = [], _segments(spec, pieces[0].shape[d] * M, M) if not \
        spec.parts else spec.parts
    offsets = [0] * M                 # each rank's place in its own piece
    for seg, groups in segs:
        taken = 0
        for r in range(M):
            first, width = _piece(seg, groups, M, r)
            if width and first == taken:
                out.append(pieces[r].narrow(d, offsets[r], width))
                taken += width
            offsets[r] += width
    return torch.cat(out, dim=d)


# ---------------------------------------------------------------------------
# run time: the plan over a model call, and the layers' collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A sequence-split cache's layout on this rank (``prefer_seq``):
    rank ``rank`` of ``tp`` holds rows ``[rank T_r, (rank + 1) T_r)`` of
    all KV heads; each rank computes the new token's K/V for its own
    heads, which ``split`` gives for every rank (:func:`head_split`)."""
    rank: int
    tp: int
    split: HeadSplit


@dataclasses.dataclass(frozen=True)
class _Scope:
    plan: ShardingPlan
    cfg: ModelConfig          # the rank's local configuration
    vocab_split: bool         # embed and lm_head hold a vocabulary slice
    kv_shared: Any = None     # the group sharing this rank's KV head
    seq: Optional[SeqShard] = None
    kv_whole: bool = False    # one KV head, its projections on every rank


_SCOPE: contextvars.ContextVar = contextvars.ContextVar("tp_scope",
                                                        default=None)


@contextlib.contextmanager
def use_plan(plan: Optional[ShardingPlan], cfg: Optional[ModelConfig] = None):
    """Scope under which the layers run the rank's part of a model call
    of the (global) configuration ``cfg``; a None plan (or one with no
    tensor parallelism) is one device."""
    scope = None
    if plan is not None and plan.tp > 1:
        split = None if cfg.use_mla else head_split(cfg, plan.tp)
        seq = None
        if plan.prefer_seq and seq_split_cache(cfg):
            seq = SeqShard(plan.rank, plan.tp, split)
        scope = _Scope(plan, local_config(cfg, plan.tp, plan.rank),
                       vocab_parallel(cfg, plan.tp), plan.kv_group, seq,
                       split is not None and split.kv_whole)
    token = _SCOPE.set(scope)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def current_plan() -> Optional[ShardingPlan]:
    scope = _SCOPE.get()
    return None if scope is None else scope.plan


def seq_split_cache(cfg: ModelConfig) -> bool:
    """True when ``prefer_seq`` splits ``cfg``'s attention cache by
    sequence: a GQA cache (dense, moe, zamba's shared block).  MLA's
    latent stays whole on every rank, as the port places it; the
    recurrent states keep their heads; enc-dec's caches keep their heads."""
    return (not cfg.use_mla and not cfg.is_encdec
            and cfg.family in ("dense", "moe", "zamba"))


def seq_shard() -> Optional[SeqShard]:
    """The sequence-split cache layout inside :func:`use_plan` of a
    ``prefer_seq`` plan (None otherwise)."""
    scope = _SCOPE.get()
    return None if scope is None else scope.seq


def local_heads() -> Optional[tuple]:
    """(query heads, KV heads) of the rank inside :func:`use_plan`."""
    scope = _SCOPE.get()
    return None if scope is None else (scope.cfg.n_heads, scope.cfg.n_kv_heads)


def kv_whole() -> bool:
    """True inside :func:`use_plan` when every rank holds the whole K/V
    projections (one KV head, kept by every rank)."""
    scope = _SCOPE.get()
    return scope is not None and scope.kv_whole


# this process's collectives since the last reset: calls, host seconds
# inside them and bytes moved (what the chip smoke reads per step), the
# calls by kind ('all_reduce', 'all_gather', 'reduce_scatter') and the
# bytes by kind.  A collective over ``meta`` tensors never runs; inside
# :func:`counting_meta` (a shape-only trace: the dry run) it is recorded
# with its bytes, elsewhere (a controller's shadows of another instance)
# it is not.
_COLLECTIVES = {"calls": 0, "seconds": 0.0, "bytes": 0, "kinds": {},
                "bytes_by_kind": {}}
_COUNT_META: contextvars.ContextVar = contextvars.ContextVar("count_meta",
                                                            default=False)


@contextlib.contextmanager
def counting_meta():
    """Scope in which collectives over ``meta`` tensors are recorded."""
    token = _COUNT_META.set(True)
    try:
        yield
    finally:
        _COUNT_META.reset(token)


def count_meta_collective(kind: str, t: torch.Tensor) -> None:
    """Record a collective over the ``meta`` tensor ``t`` (its bytes as
    :func:`count_collective` counts them) inside :func:`counting_meta`."""
    if _COUNT_META.get():
        count_collective(kind, time.perf_counter(),
                         t.numel() * t.element_size())


def collective_stats() -> dict:
    out = dict(_COLLECTIVES)
    out["kinds"] = dict(_COLLECTIVES["kinds"])
    out["bytes_by_kind"] = dict(_COLLECTIVES["bytes_by_kind"])
    return out


def reset_collective_stats() -> None:
    _COLLECTIVES.update(calls=0, seconds=0.0, bytes=0, kinds={},
                        bytes_by_kind={})


def count_collective(kind: str, t0: float, nbytes: int) -> None:
    """Record one collective that started at ``t0`` and moved ``nbytes``
    (this rank's buffer: an all_reduce's, an all_gather's gathered
    output, a reduce_scatter's input)."""
    _COLLECTIVES["calls"] += 1
    _COLLECTIVES["seconds"] += time.perf_counter() - t0
    _COLLECTIVES["bytes"] += nbytes
    kinds, by = _COLLECTIVES["kinds"], _COLLECTIVES["bytes_by_kind"]
    kinds[kind] = kinds.get(kind, 0) + 1
    by[kind] = by.get(kind, 0) + nbytes


def _reduce(buf: torch.Tensor, plan: ShardingPlan, op=None,
            group: Any = None) -> None:
    """Sum (or ``op``) ``buf`` (fp32) over the plan's model ranks (or
    ``group``'s) in place; on ``meta`` recorded only."""
    if buf.is_meta:
        count_meta_collective("all_reduce", buf)
        return
    group = plan.group if group is None else group
    if group is None:
        raise RuntimeError("this sharding plan has no process group: its "
                           "model calls cannot run their collectives")
    import torch.distributed as dist
    t0 = time.perf_counter()
    dist.all_reduce(buf, op=op or dist.ReduceOp.SUM, group=group)
    count_collective("all_reduce", t0, buf.numel() * buf.element_size())


def _sum_over_ranks(x: torch.Tensor, plan: ShardingPlan,
                    group: Any = None) -> torch.Tensor:
    buf = x.float()
    if buf is x:
        buf = x.clone()
    _reduce(buf, plan, group=group)
    return buf.to(x.dtype)


def gather_model(x: torch.Tensor) -> torch.Tensor:
    """``[tp, *x.shape]``: every model rank's ``x``, in rank order (one
    ``all_gather``; no gradient).  On ``meta`` recorded only."""
    plan = current_plan()
    x = x.contiguous()
    t0 = time.perf_counter()
    out = x.new_empty((plan.tp,) + tuple(x.shape))
    if x.is_meta:
        count_meta_collective("all_gather", out)
        return out
    import torch.distributed as dist
    dist.all_gather(list(out.unbind(0)), x, group=plan.group)
    count_collective("all_gather", t0, out.numel() * out.element_size())
    return out


class _SumForward(torch.autograd.Function):
    """Sum over the model ranks forward, the identity backward (a
    row-parallel product's partials; the gradient of the replicated sum
    is every rank's already)."""

    @staticmethod
    def forward(ctx, x, plan):
        return _sum_over_ranks(x, plan)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBackward(torch.autograd.Function):
    """The identity forward, a sum over the model ranks backward: where
    a replicated tensor enters work split over the ranks, each rank's
    gradient of it is a partial."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over_ranks(grad.contiguous(), ctx.plan), None


class _PlaceSlices(torch.autograd.Function):
    """The whole last axis (``total`` wide) from each rank's contiguous
    slice, this rank's at ``first`` (zeros elsewhere, summed over the
    ranks: exact); backward, the rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, plan, first=None, total=None):
        width = x.shape[-1]
        ctx.first = plan.rank * width if first is None else first
        ctx.width = width
        total = width * plan.tp if total is None else total
        full = torch.zeros(tuple(x.shape[:-1]) + (total,),
                           dtype=torch.float32, device=x.device)
        full[..., ctx.first:ctx.first + width] = x
        _reduce(full, plan)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.first:ctx.first + ctx.width], None, None, None


def rank_sum(plan: ShardingPlan):
    """A function summing a fp32 buffer over ``plan``'s model ranks (no
    gradient; a ``meta`` buffer passes through), bound to the plan: what a
    kernel's autograd Function calls in its backward, which runs outside
    the plan's scope."""
    def reduce(buf: torch.Tensor) -> torch.Tensor:
        return _sum_over_ranks(buf, plan)
    return reduce


class _SumGradColumns(torch.autograd.Function):
    """The identity forward; backward, the gradient's columns
    ``[start, stop)`` (last axis) summed over the model ranks."""

    @staticmethod
    def forward(ctx, w, plan, start, stop, group=None):
        ctx.plan, ctx.start, ctx.stop, ctx.group = plan, start, stop, group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        cols = grad[..., ctx.start:ctx.stop]
        cols.copy_(_sum_over_ranks(cols.contiguous(), ctx.plan, ctx.group))
        return grad, None, None, None, None


def sum_grad_columns(w: torch.Tensor, start: int = 0,
                     stop: Optional[int] = None) -> torch.Tensor:
    """A replicated weight whose columns ``[start, stop)`` (last axis;
    all of them by default) feed work the ranks split, through an input
    every rank holds whole: the identity forward, those columns'
    gradient summed over the model ranks backward (each rank's is its
    heads' partial).  Where the weight's input also enters the rank's
    own columns, the input's gradient is summed at its copy op
    (:func:`copy_to_model`), so it is not summed here a second time.
    ``w`` itself when no gradient flows or without a plan."""
    plan = current_plan()
    if plan is None or not (torch.is_grad_enabled() and w.requires_grad):
        return w
    stop = w.shape[-1] if stop is None else stop
    return _SumGradColumns.apply(w, plan, start, stop)


def sum_grad_kv(w: torch.Tensor) -> torch.Tensor:
    """A K/V projection leaf (``wk``, ``wv``, ``bk``, ``bv``) of a KV head
    shared by some but not all ranks (:attr:`HeadSplit.shared`): the
    identity forward, its gradient summed over the ranks that hold the
    head (the plan's ``kv_group``) backward; each rank's is the partial
    of its own query heads.  ``w`` itself otherwise."""
    scope = _SCOPE.get()
    if (scope is None or scope.kv_shared is None
            or not (torch.is_grad_enabled() and w.requires_grad)):
        return w
    return _SumGradColumns.apply(w, scope.plan, 0, w.shape[-1],
                                 scope.kv_shared)


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel product's partials over the model axis (fp32
    in flight; the identity backward); ``x`` itself without a plan or on
    ``meta``."""
    plan = current_plan()
    if plan is None:
        return x
    return _SumForward.apply(x, plan)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Where a replicated tensor enters work split over the model axis:
    the identity forward, the sum of the ranks' gradients backward; ``x``
    itself when no gradient flows or without a plan."""
    plan = current_plan()
    if plan is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _SumBackward.apply(x, plan)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of a vocab-parallel embedding: each rank looks up the tokens
    in its slice (zeros elsewhere) and the ranks sum, which is exact;
    backward, each rank's rows take their tokens' gradient."""
    scope = _SCOPE.get()
    tokens = tokens.long()
    if scope is None or not scope.vocab_split:
        return embed[tokens]
    plan = scope.plan
    vocab = embed.shape[0]
    first = plan.rank * vocab
    local = tokens - first
    mine = (local >= 0) & (local < vocab)
    rows = embed[local.clamp(0, vocab - 1)] * mine[..., None].to(embed.dtype)
    return _SumForward.apply(rows, plan)


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Full-vocabulary logits from each rank's slice: the slices placed in
    a zeroed full row and summed over ranks (exact: one rank adds its
    values, the others zeros)."""
    scope = _SCOPE.get()
    if scope is None or not scope.vocab_split:
        return logits
    return _PlaceSlices.apply(logits, scope.plan)


def gather_columns(x: torch.Tensor, first: Optional[int] = None,
                   total: Optional[int] = None) -> torch.Tensor:
    """The whole last axis (``total`` wide) from each rank's contiguous
    slice of it (rank ``r`` holds ``[first, first + w)``; by default ``[r
    w, (r + 1) w)`` of ``tp w``): the slices placed in a zeroed full row
    and summed over ranks (exact, one collective), as
    :func:`gather_vocab`; ``x`` itself without a plan."""
    plan = current_plan()
    if plan is None:
        return x
    return _PlaceSlices.apply(x, plan, first, total)


def vocab_split() -> bool:
    """True inside :func:`use_plan` when the head holds a vocab slice."""
    scope = _SCOPE.get()
    return scope is not None and scope.vocab_split


def vocab_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """The mean token cross-entropy (fp32) of a vocab-parallel head's
    logits ``[B, S, V / tp]`` without gathering them: each rank's max
    (one MAX reduce, no gradient), then its sums of exponentials and its
    target logits, reduced together as a ``[2, B, S]`` fp32 buffer; ``log
    sum exp - target``, as the one-device loss."""
    import torch.distributed as dist
    plan = current_plan()
    lf = logits.float()
    vocab = lf.shape[-1]
    top = lf.detach().amax(dim=-1)
    _reduce(top, plan, dist.ReduceOp.MAX)
    sumexp = torch.exp(lf - top[..., None]).sum(dim=-1)
    local = labels.long() - plan.rank * vocab
    mine = (local >= 0) & (local < vocab)
    gold = lf.gather(-1, local.clamp(0, vocab - 1)[..., None])[..., 0]
    both = _SumForward.apply(torch.stack([sumexp, gold * mine]), plan)
    return (torch.log(both[0]) + top - both[1]).mean()
