"""Phi-4-mini-3.8B [arXiv:2412.08905; hf]. RoPE SwiGLU GQA, 200k vocab."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    d_head=128,
    rope_theta=1e4,
))
