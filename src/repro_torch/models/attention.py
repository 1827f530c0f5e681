"""Attention variants: GQA (with optional QKV bias), DeepSeek-V3's MLA, and
the dispatch functions.

The full-sequence paths (train/prefill) route through the flash-attention op
(``kernels/flash_attention``: the hand-written CUDA kernels on a CUDA tensor,
its plain versions on a CPU one; differentiable, its backward a kernel of
its own); the decode paths are einsum attention over the cache (one query,
no flash needed), as in the JAX package.

Caches per layer:
  GQA : k, v (B, Hkv, max_len, Dh).
  MLA : the latent cache (B, max_len, kv_lora + qk_rope_head_dim): the
        compressed latent and the rope key, nothing re-expanded.
Decode writes the new entry into the cache in place (the JAX package returns
an updated copy).  The JAX package's sharding constraints (``constrain``,
``cache_constrain``) are the identity without a mesh and are dropped on one
card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from .common import apply_mrope, apply_rope, dense_init


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
# MLA (DeepSeek-V3)
# ==========================================================================

def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype, layers: Tuple[int, ...] = ()) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dqn, dqr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(gen, (*layers, d, qr), dtype, fan_in=d),              # down
        "wq_b": dense_init(gen, (*layers, qr, h * (dqn + dqr)), dtype, fan_in=qr),
        "wkv_a": dense_init(gen, (*layers, d, kr + dqr), dtype, fan_in=d),       # latent + rope-k
        "wkv_b": dense_init(gen, (*layers, kr, h * (dqn + dv)), dtype, fan_in=kr),
        "wo": dense_init(gen, (*layers, h * dv, d), dtype, fan_in=h * dv),
    }


def _mla_q(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> q_nope (B, h, S, dqn), q_rope (B, h, S, dqr) roped."""
    b, s, _ = x.shape
    dqn = cfg.qk_nope_head_dim
    q = ((x @ params["wq_a"]) @ params["wq_b"]).view(b, s, cfg.n_heads, -1).transpose(1, 2)
    return q[..., :dqn], apply_rope(q[..., dqn:], positions, cfg.rope_theta)


def _mla_qkv(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h, dqn, dqr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kr = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    kv = x @ params["wkv_a"]
    latent, k_rope = kv[..., :kr], kv[..., kr:]
    k_rope = apply_rope(k_rope[:, None], positions, cfg.rope_theta)     # (B, 1, S, dqr)
    kvu = (latent @ params["wkv_b"]).view(b, s, h, -1).transpose(1, 2)  # (B, h, S, dqn + dv)
    k_nope, v = kvu[..., :dqn], kvu[..., dqn:]
    k = torch.cat([k_nope, k_rope.expand(b, h, s, dqr)], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k, v, latent, k_rope


def mla_attention(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: Optional[torch.Tensor] = None, causal: bool = True) -> torch.Tensor:
    """Full-sequence MLA: flash attention with Dk = dqn + dqr, Dv = v_head_dim
    (192 and 128 at DeepSeek-V3's width: in bf16 the tensor-core kernel's
    route, ``ops.route``; q and k come from ``torch.cat``, v is a view of the
    up-projection 256 bytes in, all TMA-legal as they are)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v, _, _ = _mla_qkv(params, x, positions, cfg)
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    o = flash_attention(q, k, v, causal=causal, scale=scale)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.v_head_dim)
    return o @ params["wo"]


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                   layers: Tuple[int, ...] = ()) -> Dict:
    shape = (*layers, batch, max_len, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    return {"latent": torch.zeros(shape, dtype=dtype, device=device)}


def _mla_step(params, x: torch.Tensor, cache: Dict, pos: int, cfg: ModelConfig):
    """The query of the new token and its latent entry written into the
    cache: -> (q_nope (B, h, 1, dqn), q_rope (B, h, 1, dqr), the cache's
    latent part (B, S, kr), its rope-key part (B, S, dqr), the valid mask)."""
    kr = cfg.kv_lora_rank
    p1 = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _mla_q(params, x, p1, cfg)
    kv = x @ params["wkv_a"]                                           # (B, 1, kr + dqr)
    k_rope_new = apply_rope(kv[:, None, :, kr:], p1, cfg.rope_theta)   # (B, 1, 1, dqr)
    lat = cache["latent"]
    lat[:, pos] = torch.cat([kv[:, 0, :kr], k_rope_new[:, 0, 0]], dim=-1).to(lat.dtype)
    valid = torch.arange(lat.shape[1], device=x.device) <= pos
    return q_nope, q_rope, lat[..., :kr], lat[..., kr:], valid


def mla_decode_absorbed(params: Dict, x: torch.Tensor, cache: Dict, pos: int,
                        cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Weight-absorbed MLA decode (the JAX package's ``cfg.mla_absorb``):
    wkv_b's key half is absorbed into the query (rank kr) and attention runs
    over the cached latent itself; the value half is applied after the
    softmax.  Products in float32, as the JAX package's
    ``preferred_element_type``."""
    b = x.shape[0]
    h, dqn, dqr, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    q_nope, q_rope, latent_all, k_rope_all, valid = _mla_step(params, x, cache, pos, cfg)
    wkv_b = params["wkv_b"].reshape(kr, h, dqn + dv)
    w_k, w_v = wkv_b[..., :dqn], wkv_b[..., dqn:]                      # (kr, h, dqn / dv)
    lat_f = latent_all.float()
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, :, 0].float(), w_k.float())
    s_nope = torch.einsum("bhr,bsr->bhs", q_eff.to(latent_all.dtype).float(), lat_f)
    s_rope = torch.einsum("bhqd,bsd->bhs", q_rope.float(), k_rope_all.float())
    s = ((s_nope + s_rope) * (dqn + dqr) ** -0.5).masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=-1)                                       # (B, h, S)
    ctx = torch.einsum("bhs,bsr->bhr", p.to(latent_all.dtype).float(), lat_f)
    o = torch.einsum("bhr,rhd->bhd", ctx.to(w_v.dtype).float(), w_v.float())
    o = o.reshape(b, 1, h * dv).to(x.dtype)
    return o @ params["wo"], cache


def mla_decode(params: Dict, x: torch.Tensor, cache: Dict, pos: int,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Latent-cache decode: re-expands K and V from the cached latent
    (B, S, kr) every step; ``cfg.mla_absorb`` takes the absorbed form."""
    if cfg.mla_absorb:
        return mla_decode_absorbed(params, x, cache, pos, cfg)
    b = x.shape[0]
    h, dqn, dqr, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, latent_all, k_rope_all, valid = _mla_step(params, x, cache, pos, cfg)
    kvu = latent_all @ params["wkv_b"].to(latent_all.dtype)
    kvu = kvu.view(b, -1, h, dqn + dv).transpose(1, 2)                 # (B, h, S, dqn + dv)
    k_nope, v = kvu[..., :dqn], kvu[..., dqn:]
    s_nope = torch.einsum("bhqd,bhsd->bhqs", q_nope.float(), k_nope.float())
    s_rope = torch.einsum("bhqd,bsd->bhqs", q_rope.float(), k_rope_all.float())
    s = ((s_nope + s_rope) * (dqn + dqr) ** -0.5).masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqs,bhsd->bhqd", p.to(v.dtype).float(), v.float())
    o = o.transpose(1, 2).reshape(b, 1, h * dv).to(x.dtype)
    return o @ params["wo"], cache


# ==========================================================================
# dispatch
# ==========================================================================

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   layers: Tuple[int, ...] = ()) -> Dict:
    if cfg.attn_kind == "mla":
        return init_mla(gen, cfg, dtype, layers)
    return init_gqa(gen, cfg, dtype, layers)


def attention(params, x, cfg: ModelConfig, positions=None, mrope_pos=None, causal=True):
    if cfg.attn_kind == "mla":
        return mla_attention(params, x, cfg, positions, causal=causal)
    return gqa_attention(params, x, cfg, positions, mrope_pos, causal=causal)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
               layers: Tuple[int, ...] = ()):
    if cfg.attn_kind == "mla":
        return init_mla_cache(cfg, batch, max_len, dtype, device, layers)
    return init_gqa_cache(cfg, batch, max_len, dtype, device, layers)


def decode(params, x, cache, pos: int, cfg: ModelConfig, mrope_pos3=None):
    if cfg.attn_kind == "mla":
        return mla_decode(params, x, cache, pos, cfg)
    return gqa_decode(params, x, cache, pos, cfg, mrope_pos3=mrope_pos3)
