"""Zamba2-2.7B — Mamba2 backbone + SHARED attention block every 6 layers
[arXiv:2411.15242].  n_layers counts mamba blocks; the shared attn+mlp
(one weight set, applied 9x) follows each 6-block unit — the extreme
weight-dedup case for TIDAL's template (stored once, streamed first)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="zamba",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_heads=80, ssm_expand=2, ssm_chunk=128, conv_width=4,
    attn_every=6,
    attention_kind="hybrid",
    dtype="bfloat16",
)
