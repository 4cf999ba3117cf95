"""Whisper-medium — enc-dec, conv frontend STUB [arXiv:2212.04356].
The prefill takes precomputed frame embeddings [B, seq, d_model]
(``data.pipeline.make_frames``); decoder length = min(448, seq).
24 encoder + 24 decoder layers."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    is_encdec=True, dec_layers=24, max_dec_len=448,
    frontend="audio_stub",
    attention_kind="full",
    dtype="bfloat16",
)
