"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — M-RoPE, dynamic
resolution.  Modality frontend is a STUB: input_specs() provides precomputed
patch embeddings for a fixed vision prefix; M-RoPE 3-component rotary is
implemented in full.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    d_head=128,
    qkv_bias=True,
    rope_theta=1e6,
    mrope=True,
    vision_prefix=256,
    vision_grid=(16, 16),
))
