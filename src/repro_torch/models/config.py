"""Model configuration (the port's own copy of ``repro.models.config``).

Fields that only steer the TPU build (Pallas vs XLA attention, GSPMD
sharding hints) are left out: the port picks its attention
implementation from the device a tensor lives on.  ``remat`` is kept:
the training forward recomputes each checkpointed block in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | xlstm | zamba | moe | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default d_model // n_heads

    # --- attention extras ---
    qk_norm: bool = False                # qwen3 / chameleon
    qkv_bias: bool = False               # qwen2.5
    tied_embeddings: bool = False        # gemma / smollm: lm_head tied to embed
    scale_embed: bool = False            # gemma: embeddings scaled by sqrt(d)
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0

    # --- mlp activation: 'silu' (SwiGLU) | 'gelu' (GeGLU) ---
    act: str = "silu"

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / recurrent ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_width: int = 4
    slstm_every: int = 0
    attn_every: int = 0
    mlstm_proj_factor: float = 2.0

    # --- encoder-decoder (whisper) ---
    is_encdec: bool = False
    dec_layers: int = 0
    max_dec_len: int = 448

    # --- modality frontend stub ---
    frontend: str = "none"

    # --- numerics ---
    norm_eps: float = 1e-6
    dtype: str = "float32"               # compute/param dtype for live runs
    remat: bool = True                   # checkpoint each block in training
    # fused projections: single [D, 2F] GLU matmul / single QKV matmul
    fused_glu: bool = False
    fused_qkv: bool = False

    attention_kind: str = "full"         # full | recurrent | hybrid

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def expert_range(self) -> tuple:
        """The experts ``[first, end)`` this configuration holds: all of
        them on one device (see :class:`RankConfig`)."""
        return (0, self.n_experts)

    @property
    def shared_width(self) -> int:
        """The shared experts' MLP width (all of it on one device)."""
        return (self.moe_d_ff or self.d_ff) * self.n_shared_experts

    # the recurrent mixers' inner widths (see :class:`RankConfig`)
    @property
    def mamba_width(self) -> int:
        """Mamba2's ``d_inner``: the channels of its ``ssm_heads``."""
        return self.ssm_expand * self.d_model

    @property
    def mlstm_input_width(self) -> int:
        """The mLSTM's ``x_inner`` width, which ``wq`` / ``wk`` / ``wv``
        contract over: whole on every rank."""
        return int(self.mlstm_proj_factor * self.d_model)

    @property
    def mlstm_width(self) -> int:
        """The mLSTM heads' width (q, k, v, the gate ``z`` and the norm)."""
        return self.mlstm_input_width

    @property
    def slstm_width(self) -> int:
        """The sLSTM heads' width (``d_model`` on one device)."""
        return self.d_model

    @property
    def slstm_mlp_width(self) -> int:
        """The sLSTM post-MLP's width, ``int(4 d_model / 3)``."""
        return int(4 * self.d_model / 3)

    @property
    def slstm_mlp_split(self) -> bool:
        """The sLSTM post-MLP holds a slice of its width (its partial
        sums then meet in an ``all_reduce``); False on one device."""
        return False

    @property
    def head_first(self) -> int:
        """The first of the query heads this configuration holds (0 on one
        device; see :class:`RankConfig`)."""
        return 0

    @property
    def heads_total(self) -> int:
        """The model's query heads, all of them (on every rank)."""
        return self.n_heads

    @property
    def mlstm_head_dim(self) -> int:
        """One mLSTM head's width."""
        return ModelConfig.mlstm_width.fget(self) // self.heads_total

    @property
    def slstm_head_dim(self) -> int:
        """One sLSTM head's width."""
        return ModelConfig.slstm_width.fget(self) // self.heads_total

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RankConfig(ModelConfig):
    """One tensor-parallel rank's configuration
    (``distributed.sharding.local_config``): the shard's head, width and
    vocabulary counts in the base fields, and the expert-parallel part of
    a moe layer stored explicitly.  ``n_experts`` and ``capacity_factor``
    stay global (routing and the capacity read them); the rank holds
    experts ``[expert_first, expert_first + n_local_experts)`` and the
    shared experts' width ``shared_d_ff``.  The recurrent mixers' widths
    are the rank's heads' (``d_model`` stays global): Mamba2's channels
    ``mamba_d_inner`` (its ``ssm_heads`` are in the base field), the
    mLSTM heads' ``mlstm_d_inner`` (its ``x_inner`` input stays whole),
    the sLSTM heads' ``slstm_d`` and the sLSTM post-MLP's ``slstm_d_ff``
    (all of it where the model axis does not divide it).  Heads split
    unevenly where the model axis does not divide them
    (``distributed.sharding.head_split``): the rank's query heads are
    ``[first_head, first_head + n_heads)`` of ``n_heads_total``, and a
    rank may hold none."""
    first_head: int = 0
    n_heads_total: int = 0
    expert_first: int = 0
    n_local_experts: int = 0
    shared_d_ff: int = 0
    mamba_d_inner: int = 0
    mlstm_d_inner: int = 0
    slstm_d: int = 0
    slstm_d_ff: int = 0

    @property
    def expert_range(self) -> tuple:
        return (self.expert_first, self.expert_first + self.n_local_experts)

    @property
    def head_first(self) -> int:
        return self.first_head

    @property
    def heads_total(self) -> int:
        return self.n_heads_total

    @property
    def shared_width(self) -> int:
        return self.shared_d_ff

    @property
    def mamba_width(self) -> int:
        return self.mamba_d_inner

    @property
    def mlstm_width(self) -> int:
        return self.mlstm_d_inner

    @property
    def slstm_width(self) -> int:
        return self.slstm_d

    @property
    def slstm_mlp_width(self) -> int:
        return self.slstm_d_ff

    @property
    def slstm_mlp_split(self) -> bool:
        return self.slstm_d_ff != int(4 * self.d_model / 3)


def reduced(cfg: ModelConfig, **extra) -> ModelConfig:
    """A tiny config of the same family for CPU smoke tests.

    Shrinks depth/width/vocab while preserving every structural feature
    (GQA ratio, tied embeddings, ...), exactly as ``repro.models.config``
    does, so the two packages build the same smoke shapes.
    """
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, 4 // ratio),   # preserve the GQA grouping flavour
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        dtype="float32",
        remat=False,
    )
    if cfg.n_experts:
        ne, tk = min(cfg.n_experts, 8), min(cfg.top_k, 2)
        kw.update(n_experts=ne, top_k=tk, moe_d_ff=32,
                  capacity_factor=float(ne) / tk)
    if cfg.use_mla:
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_heads=4, ssm_chunk=16)
    if cfg.slstm_every:
        kw.update(slstm_every=min(cfg.slstm_every, 4), n_layers=4)
    if cfg.attn_every:
        kw.update(attn_every=2, n_layers=4)
    if cfg.is_encdec:
        kw.update(dec_layers=min(cfg.dec_layers, 2), n_layers=2, max_dec_len=16)
    kw.update(extra)
    return cfg.replace(**kw)
