"""Gradient compression with error feedback (int8), on tensors: the JAX
package's ``sharding/collectives.py`` without its ``compressed_psum``, which
needs a process group (ROADMAP A12).

At 1000+-node scale the cross-pod gradient all-reduce rides the DCN; int8
quantization with per-leaf scales cuts those bytes 4x (f32) / 2x (bf16).
Error feedback keeps the quantization noise unbiased over steps (Karimireddy
et al., 2019 — EF-SGD).  The transform plugs into the train step as
``grad_transform``.  ``torch.round`` rounds half to even, as ``jnp.round``
does, so the int8 bits and the scale equal the reference's.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..tree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32 scalar)`` with ``|x - q * scale| <= scale / 2``."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads) -> Any:
    """Simulate the int8 wire format: quantize+dequantize each leaf."""
    def f(g):
        q, s = quantize_int8(g.to(torch.float32))
        return dequantize_int8(q, s).to(g.dtype)
    return tree_map(f, grads)


class ErrorFeedback:
    """Stateful EF wrapper: g' = Q(g + e); e = (g + e) - g'."""

    def __init__(self, params_like):
        self.residual = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params_like)

    def __call__(self, grads):
        corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads, self.residual)
        sent = compress_tree(corrected)
        self.residual = tree_map(lambda c, s: c - s.to(torch.float32), corrected, sent)
        return sent
