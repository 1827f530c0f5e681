"""xLSTM-125M [arXiv:2405.04517; unverified]. Alternating sLSTM + mLSTM
blocks (12L, d_model=768, 4 heads). d_ff=0: xLSTM blocks carry their own
up/down projections instead of a separate FFN."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    d_head=192,
    slstm_every=2,      # even blocks mLSTM, odd blocks sLSTM
    ssm_heads=4,
    ssm_head_dim=192,
    tie_embeddings=True,
))
