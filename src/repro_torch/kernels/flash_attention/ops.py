"""Dispatch wrapper for grouped-query flash attention and its backward.

``flash_attention(q, k, v, causal=True, scale=None)``: q (B, Hq, Sq, Dk),
k (B, Hkv, Skv, Dk), v (B, Hkv, Skv, Dv) -> (B, Hq, Sq, Dv) in q's dtype.
CPU tensors take the plain versions, as the JAX package's non-TPU path does:
``attention_ref`` up to ``CHUNKED_THRESHOLD`` keys, ``chunked_attention_ref``
above; so do ``meta`` tensors (the dry run traces shapes through them, as
the reference's dry run lowers the plain versions on CPU devices).  CUDA
tensors launch one of the two hand-written kernels, the one ``route``
names, or raise.  ``flash_attention.launches_sm90`` and
``.launches_simt`` count the launches of each, ``.launches`` their sum.

When grad mode is on and q, k or v requires grad, the call goes through
``FlashAttentionFn``: the same forward, which also writes each row's
log-sum-exp, and a backward that recomputes the probabilities from it
(``flash_attention_bwd``: on CUDA tensors one of two hand-written kernels,
the one ``bwd_route`` names, ``csrc/flash_attention_bwd_sm90.cu`` or
``csrc/flash_attention_bwd.cu``; ``flash_attention_bwd_ref`` on CPU ones;
its launches in ``flash_attention_bwd.launches_sm90`` and ``.launches_simt``,
``.launches`` their sum).  Every other call (serving, inference) writes no
log-sum-exp and saves nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import launch_count
from . import kernel
from .ref import attention_ref, chunked_attention_ref, flash_attention_bwd_ref

# Above this KV length the CPU path uses the chunked online-softmax form.
CHUNKED_THRESHOLD = 2048
MAX_HEAD_DIM = 256
# (Dk, Dv) pairs the tensor-core libraries are instantiated for: the dense
# family's heads, Zamba2's 80-wide shared attention and DeepSeek-V3's MLA
# (qk_nope + qk_rope = 192, v 128)
SM90_DK_DV = ((64, 64), (80, 80), (128, 128), (192, 128))
ROUTES = ("sm90", "simt")
# device types that take the plain versions; every other one launches or raises
_PLAIN_DEVICES = ("cpu", "meta")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in kernel.DTYPES:
        raise ValueError(f"flash_attention: the kernel takes {sorted(map(str, kernel.DTYPES))}, "
                         f"got {q.dtype}")
    b, hq, sq, dk = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[1] != v.shape[1] or k.shape[2] != v.shape[2]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit (B, H, S, D)")
    if k.shape[3] != dk:
        raise ValueError(f"flash_attention: q has Dk={dk}, k has {k.shape[3]}")
    if hq % k.shape[1]:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if not (1 <= dk <= MAX_HEAD_DIM and 1 <= v.shape[3] <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: head dims Dk={dk}, Dv={v.shape[3]} must lie in "
                         f"[1, {MAX_HEAD_DIM}]")
    if causal and sq > k.shape[2]:
        raise ValueError(f"flash_attention: causal needs Sq <= Skv, got {sq} > {k.shape[2]}")
    if b * hq >= 1 << 16:
        raise ValueError(f"flash_attention: B*Hq={b * hq} exceeds the grid's 65535")


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel takes a CUDA call that ``_check_cuda`` passed, from
    dtypes, shapes, base addresses and strides alone.

    ``"sm90"`` (``csrc/flash_attention_sm90.cu``: TMA, wgmma) when q, k and v
    are bf16, (Dk, Dv) is one of ``SM90_DK_DV`` ((64, 64), Zamba2's (80, 80),
    (128, 128) and MLA's (192, 128)), Skv >= 1, and each tensor has a 16-byte
    aligned base, positive strides of dims 0..2 that are multiples of 16
    bytes (what a TMA tensor map takes) and a contiguous dim 3.  ``"simt"``
    (``csrc/flash_attention.cu``) for every other call: float32, whose 1e-5
    bound neither bf16 nor TF32 tensor-core products meet, other (Dk, Dv)
    pairs such as (32, 32), (64, 128) or (192, 192), unaligned views.
    """
    if q.dtype != torch.bfloat16 or k.shape[2] == 0:
        return "simt"
    if (q.shape[3], v.shape[3]) not in SM90_DK_DV:
        return "simt"
    return "sm90" if all(_tma_legal(t) for t in (q, k, v)) else "simt"


def _tma_legal(t: torch.Tensor) -> bool:
    """What a TMA tensor map takes: a 16-byte aligned base, positive strides
    of dims 0..2 that are multiples of 16 bytes, a contiguous dim 3."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) > 0 and t.stride(i) * t.element_size() % 16 == 0
                    for i in range(3)))


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor) -> str:
    """Which backward kernel takes a CUDA call, from dtypes, shapes, base
    addresses and strides alone: ``"sm90"`` (``csrc/flash_attention_bwd_sm90.cu``:
    TMA, wgmma) when ``route(q, k, v)`` gives ``"sm90"`` and ``dout`` is bf16
    with a 16-byte aligned base, positive strides of dims 0..2 that are
    multiples of 16 bytes and a contiguous dim 3; ``"simt"``
    (``csrc/flash_attention_bwd.cu``) for every other call: float32, other
    (Dk, Dv) pairs, unaligned views."""
    if route(q, k, v) == "sm90" and dout.dtype == torch.bfloat16 and _tma_legal(dout):
        return "sm90"
    return "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention, suffix-aligned causal mask; softmax in float32."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be (B, H, S, D)")
    if scale is None:
        scale = q.shape[3] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, float(scale))
    return _forward(q, k, v, causal, scale, with_lse=False)[0]


def _forward(q, k, v, causal: bool, scale: float, with_lse: bool):
    """``(out, lse or None)``: the plain versions on CPU and meta tensors, the kernel
    ``route`` names on CUDA ones (writing the float32 log-sum-exp (B, Hq,
    Sq) only when ``with_lse``)."""
    if q.device.type in _PLAIN_DEVICES:
        fn = chunked_attention_ref if k.shape[2] > CHUNKED_THRESHOLD else attention_ref
        if with_lse:
            return fn(q, k, v, causal=causal, scale=scale, return_lse=True)
        return fn(q, k, v, causal=causal, scale=scale), None
    _check_cuda(q, k, v, causal)
    # the kernel takes any strides of dims 0..2 (the model hands it transposed
    # views) but a contiguous last dim
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    b, hq, sq, _ = q.shape
    out = torch.empty((b, hq, sq, v.shape[3]), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse
           else None)
    if out.numel():
        which = route(q, k, v)
        launch = kernel.flash_attention_sm90 if which == "sm90" else kernel.flash_attention
        with torch.cuda.device(q.device):
            launch(q, k, v, out, float(scale), causal, lse)
        launch_count.count(flash_attention)
        launch_count.count(flash_attention, f"launches_{which}")
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward saves q, k, v, the
    output and its log-sum-exp; the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = _forward(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None


def _check_bwd_cuda(q, k, v, out, lse, dout, causal: bool) -> None:
    _check_cuda(q, k, v, causal)
    want = (*q.shape[:3], v.shape[3])        # (B, Hq, Sq, Dv)
    for name, t, dtype in (("out", out, q.dtype), ("dout", dout, q.dtype)):
        if tuple(t.shape) != want or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {want} {dtype} on {q.device}")
    if tuple(lse.shape) != want[:3] or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse is {tuple(lse.shape)} {lse.dtype}, want "
                         f"{want[:3]} float32")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        scale: Optional[float] = None):
    """``(dq, dk, dv)`` of ``flash_attention`` from its inputs, its output
    ``out``, the forward's float32 log-sum-exp ``lse`` (B, Hq, Sq) and the
    output's gradient ``dout``.  CPU tensors take ``flash_attention_bwd_ref`` (as do meta ones);
    CUDA tensors launch the kernel ``bwd_route`` names (Dk, Dv <= 256;
    float32 or bf16) or raise.  The gradients come
    back contiguous, in the inputs' dtypes; two launches on the same inputs
    give the same bits."""
    if scale is None:
        scale = q.shape[3] ** -0.5
    if q.device.type in _PLAIN_DEVICES:
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, scale=scale)
    _check_bwd_cuda(q, k, v, out, lse, dout, causal)
    which = bwd_route(q, k, v, dout)   # on the tensors as given: no copy picks the route
    # the SIMT kernel takes any strides of dims 0..2 but a contiguous last dim
    q, k, v, dout = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v, dout))
    out, lse = out.contiguous(), lse.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if k.shape[2] == 0:                   # no keys: nothing attends, every gradient is 0
        return dq.zero_(), dk, dv
    if q.numel():
        with torch.cuda.device(q.device):
            if which == "sm90":
                aux = torch.empty(kernel.bwd_sm90_scratch_shape(q), dtype=torch.float32,
                                  device=q.device)
                kernel.flash_attention_bwd_sm90(q, k, v, out, dout, lse, aux, dq, dk, dv,
                                                float(scale), causal)
            else:
                delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
                kernel.flash_attention_bwd(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                           float(scale), causal)
        launch_count.count(flash_attention_bwd)
        launch_count.count(flash_attention_bwd, f"launches_{which}")
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


def reset_launches() -> None:
    """Sets every launch count of ``flash_attention`` and
    ``flash_attention_bwd`` (sums and routes) to 0."""
    for fn in (flash_attention, flash_attention_bwd):
        fn.launches = 0
        for name in ROUTES:
            setattr(fn, f"launches_{name}", 0)


def launches_by_route(fn=flash_attention) -> dict:
    """``{"sm90": n, "simt": n}``: the launches of ``fn`` (``flash_attention``
    or ``flash_attention_bwd``) by route."""
    return {name: getattr(fn, f"launches_{name}") for name in ROUTES}


reset_launches()
