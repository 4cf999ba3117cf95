"""Qwen2.5-32B — GQA kv=8, QKV bias [hf:Qwen/Qwen2.5-32B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
    attention_kind="full",
    dtype="bfloat16",
)
