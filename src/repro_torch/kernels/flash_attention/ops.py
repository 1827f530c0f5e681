"""Dispatch wrapper for grouped-query flash attention.

``flash_attention(q, k, v, causal=True, scale=None)``: q (B, Hq, Sq, Dk),
k (B, Hkv, Skv, Dk), v (B, Hkv, Skv, Dv) -> (B, Hq, Sq, Dv) in q's dtype.
CPU tensors take the plain versions, as the JAX package's non-TPU path does:
``attention_ref`` up to ``CHUNKED_THRESHOLD`` keys, ``chunked_attention_ref``
above.  CUDA tensors launch one of the two hand-written kernels, the one
``route`` names, or raise.  ``flash_attention.launches_sm90`` and
``.launches_simt`` count the launches of each, ``.launches`` their sum.
The kernels have no backward yet: a CUDA call under grad mode with an input
that requires grad raises (``check_no_grad``) instead of returning an output
with no autograd history.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import launch_count
from . import kernel
from .ref import attention_ref, chunked_attention_ref

# Above this KV length the CPU path uses the chunked online-softmax form.
CHUNKED_THRESHOLD = 2048
MAX_HEAD_DIM = 256
# head dims the tensor-core kernel is instantiated for (Dk == Dv)
SM90_HEAD_DIMS = (64, 128)
ROUTES = ("sm90", "simt")


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


def check_no_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise when autograd would record this call: grad mode is on and any
    of q, k, v requires grad.  The CUDA kernels fill their output through a
    plain C entry point, so it would carry no ``grad_fn`` and every earlier
    layer would silently get no gradient.  The backward is ROADMAP A11's."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the CUDA kernels have no backward yet (ROADMAP A11); call it "
            "under torch.no_grad() or torch.inference_mode(), or detach q, k and v")


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel takes a CUDA call that ``_check_cuda`` passed, from
    dtypes, shapes, base addresses and strides alone.

    ``"sm90"`` (``csrc/flash_attention_sm90.cu``: TMA, wgmma) when q, k and v
    are bf16, Dk == Dv in ``SM90_HEAD_DIMS``, Skv >= 1, and each tensor has
    a 16-byte aligned base, positive strides of dims 0..2 that are multiples
    of 16 bytes (what a TMA tensor map takes) and a contiguous dim 3.
    ``"simt"`` (``csrc/flash_attention.cu``) for every other call: float32,
    whose 1e-5 bound neither bf16 nor TF32 tensor-core products meet,
    Dk != Dv, other head dims, unaligned views.
    """
    if q.dtype != torch.bfloat16 or k.shape[2] == 0:
        return "simt"
    if q.shape[3] != v.shape[3] or q.shape[3] not in SM90_HEAD_DIMS:
        return "simt"
    for t in (q, k, v):
        if t.stride(3) != 1 or t.data_ptr() % 16:
            return "simt"
        if any(t.stride(i) <= 0 or t.stride(i) * t.element_size() % 16 for i in range(3)):
            return "simt"
    return "sm90"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention, suffix-aligned causal mask; softmax in float32."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be (B, H, S, D)")
    if scale is None:
        scale = q.shape[3] ** -0.5
    if q.device.type == "cpu":
        if k.shape[2] > CHUNKED_THRESHOLD:
            return chunked_attention_ref(q, k, v, causal=causal, scale=scale)
        return attention_ref(q, k, v, causal=causal, scale=scale)
    check_no_grad(q, k, v)
    _check_cuda(q, k, v, causal)
    # the kernel takes any strides of dims 0..2 (the model hands it transposed
    # views) but a contiguous last dim
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    b, hq, sq, _ = q.shape
    out = torch.empty((b, hq, sq, v.shape[3]), dtype=q.dtype, device=q.device)
    if out.numel():
        which = route(q, k, v)
        launch = kernel.flash_attention_sm90 if which == "sm90" else kernel.flash_attention
        with torch.cuda.device(q.device):
            launch(q, k, v, out, float(scale), causal)
        launch_count.count(flash_attention)
        launch_count.count(flash_attention, f"launches_{which}")
    return out


def reset_launches() -> None:
    """Sets every launch count of ``flash_attention`` to 0."""
    flash_attention.launches = 0
    for name in ROUTES:
        setattr(flash_attention, f"launches_{name}", 0)


def launches_by_route() -> dict:
    return {name: getattr(flash_attention, f"launches_{name}") for name in ROUTES}


reset_launches()
