"""Shared model components: norms, rotary embeddings (incl. M-RoPE), SwiGLU,
initializers, embedding.  Pure functional style, as in the JAX package:
params are nested dicts of tensors under the JAX names and shapes, weights
are ``(in, out)`` and applied as ``x @ W``; every module provides ``init_*``
and an apply function.

Initializers take an explicit ``torch.Generator`` (on the target device) in
place of a ``jax.random`` key.  ``jax.random.truncated_normal(-2, 2) * std``
becomes ``trunc_normal_(t, 0, std, -2 std, 2 std)``: the same distribution,
other numbers, so parity tests carry the JAX parameters across with
``repro_torch.interop.params_from_numpy``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

NEG_LOGIT = -1e30   # padded-vocab logits


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _trunc_normal(gen: torch.Generator, shape: Sequence[int], std: float, dtype) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return t.to(dtype)


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Truncated normal with std 1/sqrt(fan_in); ``fan_in`` defaults to
    ``shape[0]``, or ``shape[1]`` for a stacked (L, in, out) weight."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) < 3 else shape[-2]
    return _trunc_normal(gen, shape, 1.0 / math.sqrt(fan_in), dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype) -> torch.Tensor:
    return _trunc_normal(gen, shape, 0.02, dtype)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Callers pass no ``eps``, as in the JAX package: 1e-5 whatever
    ``cfg.norm_eps`` says."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary embeddings — standard RoPE and Qwen2-VL M-RoPE
# --------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
                            / d_head))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, D); positions: broadcastable to (..., S). Half-split RoPE,
    computed in float32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)            # (D/2,)
    angles = positions[..., None].float() * freqs                      # (..., S, D/2)
    return _rotate(x, angles)


def mrope_positions(seq_len: int, vision_prefix: int, grid: Tuple[int, int], start: int = 0,
                    device=None) -> torch.Tensor:
    """Qwen2-VL M-RoPE position ids: int32[3, S] = (temporal, height, width).

    The vision prefix occupies a (grid_h × grid_w) patch raster at temporal
    position 0; text tokens resume with all three components equal,
    offset past the vision span."""
    gh, gw = grid
    vp = min(vision_prefix, seq_len)
    idx = torch.arange(vp, dtype=torch.int32, device=device)
    t_vis = torch.zeros((vp,), dtype=torch.int32, device=device)
    text_start = max(gh, gw)
    t_txt = torch.arange(seq_len - vp, dtype=torch.int32, device=device) + text_start
    pos = torch.stack([torch.cat([t_vis, t_txt]), torch.cat([idx // gw, t_txt]),
                       torch.cat([idx % gw, t_txt])])
    return pos + start


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """M-RoPE: frequency channels split into (t, h, w) sections (scaled to
    d_head/2 lanes).  x: (B, H, S, D); pos3: (3, S)."""
    half = x.shape[-1] // 2
    total = sum(sections)
    sec = [max(1, round(s * half / total)) for s in sections]
    sec[2] = half - sec[0] - sec[1]
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    comp = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                      for i, n in enumerate(sec)])
    angles = pos3[comp, :].T.float() * freqs                           # (S, half)
    return _rotate(x, angles)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, f: int, dtype, layers: Tuple[int, ...] = ()) -> Dict:
    """``layers`` = (L,) makes the weights of L stacked blocks at once."""
    return {
        "wi": dense_init(gen, (*layers, d, f), dtype),
        "wg": dense_init(gen, (*layers, d, f), dtype),
        "wo": dense_init(gen, (*layers, f, d), dtype, fan_in=f),
    }


def mlp(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU in the compute dtype."""
    h = x @ params["wi"]
    g = x @ params["wg"]
    return (F.silu(g) * h) @ params["wo"]


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype, tie: bool,
                   padded_vocab: Optional[int] = None) -> Dict:
    """Tables are allocated at ``padded_vocab``; pad logits are masked to
    -1e30 in ``unembed``, so they never win argmax."""
    vp = padded_vocab or vocab
    p = {"table": embed_init(gen, (vp, d), dtype)}
    if not tie:
        p["head"] = dense_init(gen, (d, vp), dtype)
    return p


def embed(params: Dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return params["table"].to(compute_dtype)[tokens]


def unembed(params: Dict, x: torch.Tensor, logits_fp32: bool = True,
            vocab: Optional[int] = None) -> torch.Tensor:
    """Logits in x's dtype (rounded there), masked past ``vocab``, then cast
    to float32 when ``logits_fp32``."""
    if "head" in params:
        out = x @ params["head"].to(x.dtype)
    else:
        out = x @ params["table"].to(x.dtype).T
    if vocab is not None and vocab != out.shape[-1]:
        out[..., vocab:] = NEG_LOGIT    # out is a fresh product: masked in place
    return out.float() if logits_fp32 else out


def cast_tree(tree, dtype):
    """Floating leaves cast to ``dtype``; a leaf already in it is returned as
    it is (no copy), so casting a cast tree again costs nothing."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
