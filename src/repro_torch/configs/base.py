"""Model/config system: one dataclass covers every assigned architecture
family (dense / moe / ssm / hybrid / audio enc-dec / vlm).

The fields, counts and ``reduced()`` are those of the JAX package's config
system, field for field; only ``cdtype()`` / ``pdtype()`` return
``torch.dtype``s.  The registry holds the configs this package has ported
(the dense-GQA ones); smoke tests use ``reduced()`` configs of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for one model family instance."""

    name: str
    family: str                       # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None      # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention variant
    attn_kind: str = "gqa"            # "gqa" | "mla"
    # MLA (DeepSeek-V3) dims
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0           # leading dense FFN layers (DeepSeek: 3)
    capacity_factor: float = 1.25
    mtp: bool = False                 # multi-token prediction head

    # SSM / hybrid
    ssm_state: int = 0                # Mamba2 d_state
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_chunk: int = 256
    attn_every: int = 0               # hybrid: shared attn block every k layers
    # xLSTM
    slstm_every: int = 2              # alternate sLSTM/mLSTM blocks

    # enc-dec (audio)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    frontend: str = ""                # "audio" | "vision" stub frontends

    # vlm
    mrope: bool = False
    vision_prefix: int = 256          # stub patch-embedding prefix length
    vision_grid: Tuple[int, int] = (16, 16)

    # perf knobs (§Perf hillclimb; defaults = paper-faithful baseline)
    attn_batch_shard: bool = False    # shard attention over batch, replicate heads
    seq_parallel: bool = False        # sequence-parallel residual stream (SP)
    mla_absorb: bool = False          # MLA decode weight absorption (DeepSeek-V2 §)
    flash_decoding: bool = False      # shard decode caches over seq (TP axis)
    moe_impl: str = "dispatch"        # "dispatch" (GShard dropping) | "sorted"

    # numerics
    param_dtype: str = "float32"      # master weights
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    logits_fp32: bool = True

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a TP-divisible size (pad logits are masked)."""
        return -(-self.vocab // 16) * 16

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing → long_500k cell runs."""
        return self.family in ("ssm", "hybrid")

    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model FLOPs, §Roofline)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.attn_kind == "mla":
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        dense_ffn = 3 * d * f  # SwiGLU
        if self.family == "moe":
            fe = self.d_ff_expert
            moe_ffn = (self.n_experts * 3 * d * fe
                       + self.n_shared_experts * 3 * d * fe + d * self.n_experts)
            n_moe = L - self.n_dense_layers
            ffn_total = self.n_dense_layers * dense_ffn + n_moe * moe_ffn
            return emb + L * attn + ffn_total
        if self.family == "ssm":
            # xLSTM-ish: per block ~ 8 d^2 (up/down proj + gates)
            return emb + L * 8 * d * d
        if self.family == "hybrid":
            d_in = self.ssm_heads * self.ssm_head_dim
            blk = (d * (2 * d_in + 2 * self.ssm_state + self.ssm_heads)  # in_proj
                   + d_in * d                                            # out_proj
                   + 4 * (d_in + 2 * self.ssm_state) + 3 * self.ssm_heads + d_in)
            shared_attn = 4 * d * d + 3 * d * f
            return emb + L * blk + shared_attn
        if self.is_encdec:
            Lsum = self.n_enc_layers + self.n_dec_layers
            cross = self.n_dec_layers * 2 * d * d
            return emb + Lsum * (attn + dense_ffn) + cross
        return emb + L * (attn + dense_ffn)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: shared + top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, fe, L = self.d_model, self.d_ff_expert, self.n_layers
        hd = self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.attn_kind == "mla":
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        act_ffn = (self.top_k + self.n_shared_experts) * 3 * d * fe
        dense_ffn = 3 * d * self.d_ff
        n_moe = L - self.n_dense_layers
        return emb + L * attn + self.n_dense_layers * dense_ffn + n_moe * act_ffn

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small: Dict = dict(
            n_layers=min(self.n_layers, 2 if not self.is_encdec else 0),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            d_head=32,
            rope_theta=1e4,
            scan_layers=self.n_layers > 1,
            remat=False,
        )
        if self.attn_kind == "mla":
            small.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                         qk_rope_head_dim=16, v_head_dim=32)
        if self.family == "moe":
            small.update(n_experts=8, top_k=2, d_ff_expert=64,
                         n_shared_experts=min(self.n_shared_experts, 1),
                         n_dense_layers=min(self.n_dense_layers, 1), n_layers=3)
        if self.family in ("ssm", "hybrid"):
            small.update(ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=32)
        if self.family == "hybrid":
            small.update(attn_every=2, n_layers=4)
        if self.is_encdec:
            small.update(n_enc_layers=2, n_dec_layers=2, n_layers=2)
        if self.family == "vlm":
            small.update(vision_prefix=16, vision_grid=(4, 4))
        small.update(overrides)
        return dataclasses.replace(self, **small)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    return _REGISTRY[name]


def all_arch_names():
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def load_all():
    """Register the ported configs: the dense-GQA ones.  The MoE, MLA, SSM,
    hybrid, VLM and enc-dec configs come with their families."""
    from . import (  # noqa: F401
        mistral_large_123b, phi4_mini_3_8b, qwen2_5_14b, qwen2_5_32b,
    )
