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

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


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
