"""ctypes bindings of the two hand-written CUDA flash-attention kernels, both
replacing ``flash_attention_pallas``: ``csrc/flash_attention_sm90.cu`` (TMA,
wgmma, warp-specialised; bf16, Dk == Dv in {64, 128}) and
``csrc/flash_attention.cu`` (float32 FMAs on the CUDA cores; every other
call).  ``ops.route`` picks one.  Each takes CUDA tensors that ``ops.py`` has
checked and allocated, launches on PyTorch's current stream without
synchronising, and raises when the launch is refused.
"""
from __future__ import annotations

import torch

from .. import build
from ..build import F32, I32, I64, PTR

_ARGS = (PTR, PTR, PTR, PTR, *(I64,) * 7, *(I64,) * 9, F32, I32, I32, PTR)
_SM90_ARGS = (PTR, PTR, PTR, PTR, *(I64,) * 6, *(I64,) * 9, F32, I32, PTR)
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


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                         scale: float, causal: bool) -> None:
    """The same function on the tensor cores, for calls ``ops.route`` gives
    ``"sm90"``: bf16, Dk == Dv in {64, 128}, 16-byte aligned bases and
    strides of dims 0..2 (any order: the tensor maps take them as they are)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    build.call("flash_attention_sm90", "aq_flash_attention_sm90", _SM90_ARGS,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               b, hq, hkv, sq, skv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               scale, int(causal), build.stream_of(q))
