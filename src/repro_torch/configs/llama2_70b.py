"""Llama2-70B — the paper's distributed / tensor-merging case (Table 3)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-70b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32000,
    attention_kind="full",
    dtype="bfloat16",
)
