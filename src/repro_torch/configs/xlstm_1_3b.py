"""xLSTM-1.3B — sLSTM + mLSTM blocks, 7:1 ratio [arXiv:2405.04517].

d_ff=0 per the assignment: the FFN is folded into the mLSTM up/down
projections (proj_factor 2) and the sLSTM post-MLP (factor 4/3).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_every=8,              # 7 mLSTM : 1 sLSTM
    mlstm_proj_factor=2.0,
    ssm_chunk=128, conv_width=4,
    attention_kind="recurrent",
    dtype="bfloat16",
)
