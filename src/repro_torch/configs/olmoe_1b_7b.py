"""OLMoE-1B-7B [arXiv:2409.02060; hf]. 64 experts top-8, every layer MoE."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    n_shared_experts=0,
    top_k=8,
    d_ff_expert=1024,
    n_dense_layers=0,
    rope_theta=1e4,
))
