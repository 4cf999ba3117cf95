"""Llama3-8B — a paper-evaluation model (Fig. 13-17) [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, rope_theta=5e5,
    attention_kind="full",
    dtype="bfloat16",
)
