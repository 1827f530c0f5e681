"""Plain torch versions of grouped-query attention.

``attention_ref`` is the naive form (the full score matrix, a -inf causal
mask, softmax in float32); ``chunked_attention_ref`` scans the keys in
``block_k`` tiles with an online softmax (a finite -1e30 mask, the sum floored
at 1e-30), so its peak intermediate is (B, Hq, Sq, block_k).  Both are the
JAX package's oracles written in torch.  ``ops.py`` takes them for CPU
tensors, and ``chip_smoke.py`` holds the CUDA kernel to them on the card.

Shapes: q (B, Hq, Sq, Dk), k (B, Hkv, Skv, Dk), v (B, Hkv, Skv, Dv) ->
(B, Hq, Sq, Dv) in q's dtype.  Query head h reads KV head h // (Hq / Hkv).
Causal masking is suffix-aligned: query i sees keys j <= i + (Skv - Sq).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _expand_kv(t: torch.Tensor, group: int) -> torch.Tensor:
    return t.repeat_interleave(group, dim=1) if group > 1 else t


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Naive GQA attention; softmax in float32."""
    sq, dk = q.shape[2], q.shape[3]
    skv = k.shape[2]
    group = q.shape[1] // k.shape[1]
    if scale is None:
        scale = dk ** -0.5
    kk = _expand_kv(k, group).float()
    vv = _expand_kv(v, group).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: Optional[float] = None,
                          block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention over ``block_k`` key tiles (flash-style)."""
    b, hq, sq, dk = q.shape
    skv, dv = k.shape[2], v.shape[3]
    group = hq // k.shape[1]
    if scale is None:
        scale = dk ** -0.5
    qf = q.float() * scale
    qpos = torch.arange(sq, device=q.device) + (skv - sq)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, dv), dtype=torch.float32, device=q.device)
    for start in range(0, skv, block_k):
        kk = _expand_kv(k[:, :, start:start + block_k], group).float()
        vv = _expand_kv(v[:, :, start:start + block_k], group).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kk)
        if causal:
            kpos = start + torch.arange(kk.shape[2], device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
        # the JAX oracle pads the last tile with masked keys; a short last
        # tile without them gives the same sums
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vv)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
