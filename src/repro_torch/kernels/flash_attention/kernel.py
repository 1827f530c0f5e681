"""ctypes bindings of the hand-written CUDA flash-attention kernels: the two
forward kernels, both replacing ``flash_attention_pallas``,
``csrc/flash_attention_sm90.cu`` (TMA, wgmma, warp-specialised; bf16,
(Dk, Dv) in ``ops.SM90_DK_DV``: (64, 64), (128, 128), (192, 128)) and
``csrc/flash_attention.cu`` (float32 FMAs on the CUDA cores; every other
call), ``ops.route`` picking one; and the two backward kernels,
``csrc/flash_attention_bwd_sm90.cu`` (TMA, wgmma; the same calls) and
``csrc/flash_attention_bwd.cu`` (SIMT; every other call), ``ops.bwd_route``
picking one.  Each takes CUDA tensors that ``ops.py`` has
checked and allocated, launches on PyTorch's current stream without
synchronising, and raises when the launch is refused.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import build
from ..build import F32, I32, I64, PTR

_ARGS = (PTR, PTR, PTR, PTR, PTR, *(I64,) * 7, *(I64,) * 9, F32, I32, I32, PTR)
_SM90_ARGS = (PTR, PTR, PTR, PTR, PTR, *(I64,) * 7, *(I64,) * 9, F32, I32, PTR)
_BWD_ARGS = (*(PTR,) * 10, *(I64,) * 7, *(I64,) * 12, F32, I32, I32, PTR)
_BWD_SM90_ARGS = (*(PTR,) * 10, *(I64,) * 7, *(I64,) * 12, F32, I32, PTR)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the sm90 backward's float32 scratch holds 2 rows (lse in log2 units, and
# rowsum(dO * O)) per query of each (batch, head), Sq rounded up to this
BWD_SM90_ROW_PAD = 128


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                    scale: float, causal: bool, lse: Optional[torch.Tensor] = None) -> None:
    """``out = softmax(q k^T * scale [causal mask]) v`` per query head, with
    q, k, v of one dtype in ``DTYPES``, each contiguous in its last dim, and
    ``out`` a contiguous (B, Hq, Sq, Dv) tensor of that dtype.  ``lse``, a
    contiguous float32 (B, Hq, Sq) tensor or None, gets each row's
    log-sum-exp of its scaled scores."""
    b, hq, sq, dk = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    build.call("flash_attention", "aq_flash_attention", _ARGS,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
               b, hq, hkv, sq, skv, dk, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               scale, int(causal), DTYPES[q.dtype], build.stream_of(q))


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                         scale: float, causal: bool, lse: Optional[torch.Tensor] = None) -> None:
    """The same function on the tensor cores, for calls ``ops.route`` gives
    ``"sm90"``: bf16, (Dk, Dv) in {(64, 64), (128, 128), (192, 128)}, 16-byte
    aligned bases and strides of dims 0..2 (any order: the tensor maps take
    them as they are)."""
    b, hq, sq, dk = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    build.call("flash_attention_sm90", "aq_flash_attention_sm90", _SM90_ARGS,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
               b, hq, hkv, sq, skv, dk, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               scale, int(causal), build.stream_of(q))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                        dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, scale: float,
                        causal: bool) -> None:
    """dq, dk, dv (contiguous, the inputs' dtype) of attention from q, k
    (Dk wide), v and ``dout`` (Dv wide; each contiguous in its last dim),
    ``out`` and the float32 ``lse`` (contiguous); ``delta`` is float32
    (B, Hq, Sq) scratch.  Three kernels in order on the current stream:
    rowsum(dO * O), dK/dV, dQ."""
    b, hq, sq, dk_ = q.shape
    hkv, skv, dv_ = k.shape[1], k.shape[2], v.shape[3]
    build.call("flash_attention_bwd", "aq_flash_attention_bwd", _BWD_ARGS,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
               lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               b, hq, hkv, sq, skv, dk_, dv_, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *dout.stride()[:3], scale, int(causal), DTYPES[q.dtype], build.stream_of(q))


def bwd_sm90_scratch_shape(q: torch.Tensor) -> tuple:
    """Shape of the float32 scratch ``flash_attention_bwd_sm90`` takes."""
    b, hq, sq, _ = q.shape
    return (2, b * hq, -(-sq // BWD_SM90_ROW_PAD) * BWD_SM90_ROW_PAD)


def flash_attention_bwd_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                             aux: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
                             dv: torch.Tensor, scale: float, causal: bool) -> None:
    """The same gradients on the tensor cores, for calls ``ops.bwd_route``
    gives ``"sm90"``: bf16 q, k, v and ``dout``, (Dk, Dv) in {(64, 64),
    (128, 128), (192, 128)}, 16-byte aligned bases and strides of dims 0..2
    (any order).  ``out`` and
    ``lse`` contiguous; ``aux`` a contiguous float32 scratch of
    ``bwd_sm90_scratch_shape(q)``.  Three kernels in order on the current
    stream: the prologue (rowsum(dO * O), lse in log2 units), dK/dV, dQ."""
    b, hq, sq, dk_ = q.shape
    hkv, skv, dv_ = k.shape[1], k.shape[2], v.shape[3]
    build.call("flash_attention_bwd_sm90", "aq_flash_attention_bwd_sm90", _BWD_SM90_ARGS,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
               lse.data_ptr(), aux.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               b, hq, hkv, sq, skv, dk_, dv_, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *dout.stride()[:3], scale, int(causal), build.stream_of(q))
