"""Gemma-2B — GeGLU, head_dim=256, MQA (kv=1), tied+scaled embeddings
[arXiv:2403.08295; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    act="gelu", tied_embeddings=True, scale_embed=True,
    attention_kind="full",
    dtype="bfloat16",
)
