"""Chameleon-34B — early-fusion VLM [arXiv:2405.09818].  The VQ image
tokenizer is a STUB: input token ids already live in the fused 65536 vocab
(text + image codes), so the backbone is a dense decoder with qk-norm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536,
    qk_norm=True,
    frontend="vq_stub",
    attention_kind="full",
    dtype="bfloat16",
)
