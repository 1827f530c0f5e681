"""ctypes binding of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``, replacing ``flash_attention_pallas``).  Takes
CUDA tensors that ``ops.py`` has checked and allocated, launches on PyTorch's
current stream without synchronising, and raises when the launch is refused.
"""
from __future__ import annotations

import torch

from .. import build
from ..build import F32, I32, I64, PTR

_ARGS = (PTR, PTR, PTR, PTR, *(I64,) * 7, *(I64,) * 9, F32, I32, I32, PTR)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                    scale: float, causal: bool) -> None:
    """``out = softmax(q k^T * scale [causal mask]) v`` per query head, with
    q, k, v of one dtype in ``DTYPES``, each contiguous in its last dim, and
    ``out`` a contiguous (B, Hq, Sq, Dv) tensor of that dtype."""
    b, hq, sq, dk = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    build.call("flash_attention", "aq_flash_attention", _ARGS,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               b, hq, hkv, sq, skv, dk, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               scale, int(causal), DTYPES[q.dtype], build.stream_of(q))
