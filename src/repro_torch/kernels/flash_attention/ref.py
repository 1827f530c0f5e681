"""Plain torch versions of grouped-query attention.

``attention_ref`` is the naive form (the full score matrix, a -inf causal
mask, softmax in float32); ``chunked_attention_ref`` scans the keys in
``block_k`` tiles with an online softmax (a finite -1e30 mask, the sum floored
at 1e-30), so its peak intermediate is (B, Hq, Sq, block_k).  Both are the
JAX package's oracles written in torch; with ``return_lse=True`` each also
returns the float32 log-sum-exp of each row's scaled scores, (B, Hq, Sq),
which the backward recomputes the probabilities from.
``flash_attention_bwd_ref`` is that backward (FlashAttention-2's formulas,
by key chunks).  ``ops.py`` takes them for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernels to them on the card.

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
                  scale: Optional[float] = None, return_lse: bool = False):
    """Naive GQA attention; softmax in float32.  ``return_lse``: also the
    rows' log-sum-exp, ``(out, lse)``."""
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
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l, vv).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: Optional[float] = None,
                          block_k: int = 512, return_lse: bool = False):
    """Online-softmax attention over ``block_k`` key tiles (flash-style).
    ``return_lse``: also the rows' log-sum-exp, ``(out, lse)``."""
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
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l)
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                            scale: Optional[float] = None, block_k: int = 512):
    """The gradients ``(dq, dk, dv)`` of GQA attention, in q's, k's and v's
    dtypes, by FlashAttention-2's formulas in float32 over ``block_k`` key
    chunks (no (Sq, Skv) matrix is held): ``D = rowsum(dO * O)``;
    per chunk ``P = exp(q k^T * scale - lse)`` (0 where masked),
    ``dV = P^T dO``, ``dS = P * (dO V^T - D)``, ``dQ += dS K * scale``,
    ``dK = dS^T Q * scale``; the query heads of a group add into their KV
    head.  ``o`` is the forward's output and ``lse`` its float32 log-sum-exp
    (B, Hq, Sq).  Dk and Dv may differ (MLA): dq and dk are Dk wide, dv and
    ``o``, ``do`` Dv wide."""
    b, hq, sq, dk = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = dk ** -0.5
    qf, dof = q.float(), do.float()
    delta = (dof * o.float()).sum(dim=-1)                               # (B, Hq, Sq)
    qpos = torch.arange(sq, device=q.device) + (skv - sq)
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dk_parts, dv_parts = [], []
    for start in range(0, skv, block_k):
        kk = _expand_kv(k[:, :, start:start + block_k], group).float()
        vv = _expand_kv(v[:, :, start:start + block_k], group).float()
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale - lse[..., None])
        if causal:
            kpos = start + torch.arange(kk.shape[2], device=q.device)
            p = p.masked_fill(kpos[None, :] > qpos[:, None], 0.0)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vv) - delta[..., None])
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
        dv_c = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dk_c = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
        n = kk.shape[2]
        dv_parts.append(dv_c.reshape(b, hkv, group, n, -1).sum(dim=2))
        dk_parts.append(dk_c.reshape(b, hkv, group, n, -1).sum(dim=2))
    if not dk_parts:                      # no keys: every gradient is 0
        return dq.to(q.dtype), torch.zeros_like(k), torch.zeros_like(v)
    return (dq.to(q.dtype), torch.cat(dk_parts, dim=2).to(k.dtype),
            torch.cat(dv_parts, dim=2).to(v.dtype))
