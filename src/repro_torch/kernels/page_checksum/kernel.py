"""ctypes binding of the hand-written CUDA poly32 checksum kernel
(``csrc/page_checksum.cu``, replacing ``page_checksum_pallas``).  Takes CUDA
tensors that ``ops.py`` has checked and allocated, launches on PyTorch's
current stream without synchronising, and raises when the launch is refused.
"""
from __future__ import annotations

import torch

from .. import build
from ..build import I64, PTR

_ARGS = (PTR, PTR, I64, I64, PTR, PTR)


def page_checksum(rows: torch.Tensor, weights: torch.Tensor, out: torch.Tensor) -> None:
    """``out[i]`` = the poly32 checksum of uint8 row i under ``weights``."""
    build.call("page_checksum", "aq_page_checksum", _ARGS, rows.data_ptr(), weights.data_ptr(),
               rows.shape[0], rows.shape[1], out.data_ptr(), build.stream_of(rows))
