"""Zamba2-2.7B [arXiv:2411.15242; hf].

54 Mamba2 layers (d_model=2560, ssm_state=64) with a SHARED attention+MLP
block interleaved every 6 layers (the Zamba2 shared-block pattern; its
parameters are reused at every invocation point).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    d_head=80,
    ssm_state=64,
    ssm_heads=40,          # expand=2 → d_inner=5120, head_dim=128
    ssm_head_dim=128,
    ssm_chunk=256,
    attn_every=6,
    rope_theta=1e4,
))
