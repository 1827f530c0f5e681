"""SeamlessM4T-medium [arXiv:2308.11596; hf].

Enc-dec backbone (12+12L, d_model=1024, 16H, d_ff=4096, vocab=256206).
The audio frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, T_frames, d_model).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    d_head=64,
    frontend="audio",
    rope_theta=1e4,
))
