"""ctypes binding of the hand-written CUDA row gather (``csrc/page_gather.cu``,
replacing ``page_gather_pallas``).  Takes CUDA tensors that ``ops.py`` has
checked and allocated, launches on PyTorch's current stream without
synchronising, and raises when the launch is refused.
"""
from __future__ import annotations

import torch

from .. import build
from ..build import I64, PTR

_ARGS = (PTR, PTR, I64, I64, PTR, PTR)


def page_gather(pages: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> None:
    """``out[i] = pages[idx[i]]`` for int64 ``idx`` on the card."""
    build.call("page_gather", "aq_page_gather", _ARGS, pages.data_ptr(), idx.data_ptr(),
               idx.shape[0], pages.shape[1] * pages.element_size(), out.data_ptr(),
               build.stream_of(pages))
