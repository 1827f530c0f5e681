"""Gradient compression with error feedback (int8), and the compressed
all-reduce over a ``torch.distributed`` group: the twin of the JAX package's
``sharding/collectives.py``.

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
import torch.distributed as dist

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


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Compressed all-reduce over ``group`` (the default group when None),
    the reference's ``shard_map``-side ``compressed_psum``: agree on a shared
    scale (a MAX all-reduce of the local scales, one scalar on the wire),
    quantize to int8, SUM all-reduce in int32 (exact), dequantize once into
    float32.  The scale is in ``x``'s dtype, as the reference computes it,
    and crosses the wire as float32 (exact); any backend with int32 SUM and
    float32 MAX takes it: gloo on the CPU, NCCL on the card."""
    local_scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    wire = local_scale.to(torch.float32).reshape(1)
    dist.all_reduce(wire, op=dist.ReduceOp.MAX, group=group)
    scale = wire.reshape(()).to(local_scale.dtype)
    acc = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8).to(torch.int32)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return acc.to(torch.float32) * scale
