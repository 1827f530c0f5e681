"""Attention: GQA (with optional QKV bias) and the dispatch functions.

The full-sequence path (train/prefill) routes through the flash-attention op
(``kernels/flash_attention``: the hand-written CUDA kernel on a CUDA tensor,
its plain version on a CPU one); the decode path is einsum attention over the
KV cache (one query, no flash needed), as in the JAX package.

KV cache per layer: k, v (B, Hkv, max_len, Dh).  The JAX package's sharding
constraints (``constrain``, ``cache_constrain``) are the identity without a
mesh and are dropped on one card.  MLA (``attn_kind == "mla"``) comes with the
MoE/MLA family and raises here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from .common import apply_mrope, apply_rope, dense_init

_MLA = ("attn_kind 'mla' is not ported yet: it comes with the MoE/MLA family "
        "(ROADMAP A11)")


# ==========================================================================
# GQA
# ==========================================================================

def init_gqa(gen: torch.Generator, cfg: ModelConfig, dtype, layers: Tuple[int, ...] = ()) -> Dict:
    """``layers`` = (L,) makes L stacked blocks' weights at once."""
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (*layers, d, h * dh), dtype),
        "wk": dense_init(gen, (*layers, d, hk * dh), dtype),
        "wv": dense_init(gen, (*layers, d, hk * dh), dtype),
        "wo": dense_init(gen, (*layers, h * dh, d), dtype, fan_in=h * dh),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h * dh), ("bk", hk * dh), ("bv", hk * dh)):
            p[name] = torch.zeros((*layers, n), dtype=dtype, device=gen.device)
    return p


def _proj_qkv(params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> q (B, h, S, dh), k and v (B, hk, S, dh): transposed views."""
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.view(b, s, h, dh).transpose(1, 2)
    k = k.view(b, s, hk, dh).transpose(1, 2)
    v = v.view(b, s, hk, dh).transpose(1, 2)
    return q, k, v


def gqa_attention(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: Optional[torch.Tensor] = None,
                  mrope_pos: Optional[torch.Tensor] = None, causal: bool = True) -> torch.Tensor:
    """Full-sequence GQA. x: (B, S, D)."""
    b, s, _ = x.shape
    q, k, v = _proj_qkv(params, x, cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if cfg.mrope and mrope_pos is not None:
        q = apply_mrope(q, mrope_pos, cfg.rope_theta)
        k = apply_mrope(k, mrope_pos, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return o @ params["wo"]


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                   layers: Tuple[int, ...] = ()) -> Dict:
    shape = (*layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(params: Dict, x: torch.Tensor, cache: Dict, pos: int, cfg: ModelConfig,
               mrope_pos3: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """One token: x (B, 1, D) at index ``pos``.  Writes the new key and value
    into ``cache`` in place (the JAX package returns an updated copy) and
    returns ``(out, cache)``."""
    b = x.shape[0]
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    group = h // hk
    q, k, v = _proj_qkv(params, x, cfg)       # (B, h, 1, dh), (B, hk, 1, dh)
    if cfg.mrope and mrope_pos3 is not None:
        q = apply_mrope(q, mrope_pos3, cfg.rope_theta)
        k = apply_mrope(k, mrope_pos3, cfg.rope_theta)
    else:
        p1 = torch.full((1,), pos, device=x.device)
        q = apply_rope(q, p1, cfg.rope_theta)
        k = apply_rope(k, p1, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    ck[:, :, pos] = k[:, :, 0].to(ck.dtype)
    cv[:, :, pos] = v[:, :, 0].to(cv.dtype)
    qg = q.reshape(b, hk, group, dh)
    # float32 products and sums, as the JAX package's preferred_element_type
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(), ck.float()) * (dh ** -0.5)
    valid = torch.arange(ck.shape[2], device=x.device) <= pos
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=-1)
    # the probabilities are rounded to the cache dtype before the PV product
    o = torch.einsum("bkgs,bksd->bkgd", p.to(cv.dtype).float(), cv.float())
    o = o.reshape(b, 1, h * dh).to(x.dtype)
    return o @ params["wo"], cache


# ==========================================================================
# dispatch
# ==========================================================================

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   layers: Tuple[int, ...] = ()) -> Dict:
    if cfg.attn_kind == "mla":
        raise NotImplementedError(_MLA)
    return init_gqa(gen, cfg, dtype, layers)


def attention(params, x, cfg: ModelConfig, positions=None, mrope_pos=None, causal=True):
    if cfg.attn_kind == "mla":
        raise NotImplementedError(_MLA)
    return gqa_attention(params, x, cfg, positions, mrope_pos, causal=causal)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
               layers: Tuple[int, ...] = ()):
    if cfg.attn_kind == "mla":
        raise NotImplementedError(_MLA)
    return init_gqa_cache(cfg, batch, max_len, dtype, device, layers)


def decode(params, x, cache, pos: int, cfg: ModelConfig, mrope_pos3=None):
    if cfg.attn_kind == "mla":
        raise NotImplementedError(_MLA)
    return gqa_decode(params, x, cache, pos, cfg, mrope_pos3=mrope_pos3)
