"""Llama2-13B — the paper's running example (Fig. 1-4, 13-17)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-13b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=13824, vocab_size=32000,
    attention_kind="full",
    dtype="bfloat16",
)
