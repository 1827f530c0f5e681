"""ctypes bindings of the hand-written CUDA snapshot kernels (``csrc/*.cu``).

``publish`` is the fused publish sweep, one launch (replacing
``fused_publish_pallas``), ``restore_rows`` the fused
gather→checksum→scatter over a row list (replacing ``fused_restore_pallas``).  These take
CUDA tensors that ``ops.py`` has already checked and allocated, launch on
PyTorch's current stream without synchronising, and raise when the launch
is refused.  The libraries are compiled at first call (``kernels/build.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import build
from ..build import I32 as _I32
from ..build import I64 as _I64
from ..build import PTR as _P

_SIGNATURES = {
    ("fused_publish", "aq_fused_publish"): (_P, _P, _P, _I64, _I64, _I32, _P, _P, _P, _P, _P,
                                            _P),
    ("fused_restore", "aq_fused_restore_rows"): (_P, _P, _I64, _P, _P, _I64, _P, _P, _P, _P,
                                                 _P, _P),
}


def _call(lib_name: str, fn_name: str, *args) -> None:
    build.call(lib_name, fn_name, _SIGNATURES[(lib_name, fn_name)], *args)


def _stream(t: torch.Tensor) -> int:
    return build.stream_of(t)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def publish(pages: torch.Tensor, ws: torch.Tensor, weights: torch.Tensor, cold_base: int,
            tile_pages: int, zero: torch.Tensor, csum: torch.Tensor, out: torch.Tensor,
            counts: torch.Tensor, scratch: torch.Tensor) -> None:
    """The whole sweep in one pass: per-page zero flag and checksum, each
    non-zero page stored once at its row of ``out`` (hot rows from 0, cold
    rows from ``cold_base``) and ``counts = [n_hot, n_cold]``.  ``scratch``
    holds ``1 + ceil(n / tile_pages)`` 64-bit words, zeroed by the call."""
    _call("fused_publish", "aq_fused_publish", _ptr(pages), _ptr(ws), _ptr(weights),
          pages.shape[0], cold_base, tile_pages, _ptr(zero), _ptr(csum), _ptr(out),
          _ptr(counts), _ptr(scratch), _stream(pages))


def restore_rows(dest: Optional[torch.Tensor], src_base: int, src_stride: int,
                 src: Optional[torch.Tensor], dst: torch.Tensor, weights: torch.Tensor,
                 expected: Optional[torch.Tensor], csum: torch.Tensor,
                 bad: Optional[torch.Tensor], n_bad: Optional[torch.Tensor]) -> None:
    """For each row i at ``src_base + (src[i] or i) * src_stride``:
    ``dest[dst[i]]`` = the row (``dest`` None: verify only), ``csum[i]`` = its
    checksum, ``bad[i]`` = whether it differs from ``expected[dst[i]]``, and
    ``n_bad`` = how many do."""
    _call("fused_restore", "aq_fused_restore_rows", _ptr(dest), src_base, src_stride, _ptr(src),
          _ptr(dst), dst.shape[0], _ptr(weights), _ptr(expected), _ptr(csum), _ptr(bad),
          _ptr(n_bad), _stream(dst))
