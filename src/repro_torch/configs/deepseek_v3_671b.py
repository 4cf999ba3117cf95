"""DeepSeek-V3 (671B total / 37B active) — MLA, 1 shared + 256 routed
experts top-8 [arXiv:2412.19437].

As in the JAX package's config: a uniform 61-layer moe stack (the real
model's 3 dense leading layers and its multi-token prediction head are
left out) and the paper's MLA dims: q_lora 1536, kv_lora 512, nope 128,
rope 64, v_head 128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=2048, vocab_size=129280,
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    capacity_factor=1.25,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    attention_kind="full",
    dtype="bfloat16",
)
