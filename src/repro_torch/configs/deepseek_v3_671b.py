"""DeepSeek-V3-671B [arXiv:2412.19437; hf].

61L d_model=7168, MLA attention (128 heads), MoE: 1 shared + 256 routed
top-8 (d_ff_expert=2048), first 3 layers dense (d_ff=18432), MTP head.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,           # MLA: kv "heads" = q heads, latent-compressed
    d_ff=18432,               # dense-layer FFN width
    vocab=129280,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    d_ff_expert=2048,
    n_dense_layers=3,
    mtp=True,
    rope_theta=1e4,
))
