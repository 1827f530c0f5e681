"""Dispatch wrapper for zero-page detection.

``zero_detect(pages)`` returns int32[N], 1 where row i of ``pages`` is all
zero by value.  CPU tensors take the plain version (``ref.py``); CUDA tensors
launch the hand-written kernel or raise.  ``zero_detect.launches`` counts
kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import launch_count, rows
from . import kernel
from .ref import zero_detect_ref

_ALL = 0xFFFFFFFF
_F32 = 0x7FFFFFFF        # clear the sign bit of one 4-byte float
_F16 = 0x7FFF7FFF        # ... of two 2-byte floats
_F8 = 0x7F7F7F7F         # ... of four 1-byte floats
_F64 = (_ALL, _F32, _ALL, _F32)

# dtype -> the mask ANDed into each 16-byte word before the OR, so that the
# kernel's bit test is the plain version's value test (-0.0 == 0, NaN != 0)
_MASKS = {torch.float32: (_F32,) * 4, torch.complex64: (_F32,) * 4,
          torch.float16: (_F16,) * 4, torch.bfloat16: (_F16,) * 4,
          torch.float64: _F64, torch.complex128: _F64}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _MASKS[getattr(torch, _name)] = (_F8,) * 4


def value_mask(dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """The per-word mask for ``dtype``: sign bits cleared for floats, all
    ones for integers and bool."""
    if dtype in _MASKS:
        return _MASKS[dtype]
    if dtype.is_floating_point or dtype.is_complex:
        raise ValueError(f"zero_detect: no value mask for {dtype}")
    return (_ALL,) * 4


def zero_detect(pages: torch.Tensor) -> torch.Tensor:
    """pages: (N, E) any dtype -> int32[N] (1 = all-zero row)."""
    if pages.dim() != 2:
        raise ValueError(f"zero_detect: expected (N, E), got {tuple(pages.shape)}")
    if pages.device.type == "cpu":
        return zero_detect_ref(pages)
    rows.check_rows("zero_detect pages", pages)
    mask = value_mask(pages.dtype)
    out = torch.empty(pages.shape[0], dtype=torch.int32, device=pages.device)
    if pages.shape[0]:
        with torch.cuda.device(pages.device):
            kernel.zero_detect(pages, mask, out)
        launch_count.count(zero_detect)
    return out


zero_detect.launches = 0
