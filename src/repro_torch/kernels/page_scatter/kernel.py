"""ctypes binding of the hand-written CUDA row scatter
(``csrc/page_scatter.cu``, replacing ``page_scatter_pallas``).  Takes CUDA
tensors that ``ops.py`` has checked, writes ``dest`` in place on PyTorch's
current stream without synchronising, and raises when the launch is refused.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import build
from ..build import I64, PTR

_ARGS = (PTR, PTR, I64, PTR, PTR, I64, I64, PTR)


def scatter_rows(dest: torch.Tensor, src_base: int, src_stride: int,
                 src: Optional[torch.Tensor], dst: torch.Tensor) -> None:
    """``dest[dst[i]]`` = the row at ``src_base + (src[i] or i) * src_stride``."""
    build.call("page_scatter", "aq_page_scatter_rows", _ARGS, dest.data_ptr(), src_base,
               src_stride, None if src is None else src.data_ptr(), dst.data_ptr(),
               dst.shape[0], dest.shape[1] * dest.element_size(), build.stream_of(dest))
