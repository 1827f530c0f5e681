"""ctypes binding of the hand-written CUDA zero-detect kernel
(``csrc/zero_detect.cu``, replacing ``zero_detect_pallas``).  Takes CUDA
tensors that ``ops.py`` has checked and allocated, launches on PyTorch's
current stream without synchronising, and raises when the launch is refused.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import build
from ..build import I64, PTR, U32

_ARGS = (PTR, I64, I64, U32, U32, U32, U32, PTR, PTR)


def zero_detect(rows: torch.Tensor, mask: Tuple[int, int, int, int], out: torch.Tensor) -> None:
    """``out[i] = 1`` where every 16-byte word of row i ANDed with ``mask``
    is zero."""
    build.call("zero_detect", "aq_zero_detect", _ARGS, rows.data_ptr(), rows.shape[0],
               rows.shape[1] * rows.element_size(), *mask, out.data_ptr(),
               build.stream_of(rows))
