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

_ARGS = (PTR, PTR, PTR, PTR, I64, I64, PTR)


def page_scatter(dest: torch.Tensor, compact: torch.Tensor, dst: torch.Tensor,
                 src: Optional[torch.Tensor]) -> None:
    """``dest[dst[i]] = compact[src[i]]`` (``src`` None: ``i``), in place."""
    build.call("page_scatter", "aq_page_scatter", _ARGS, dest.data_ptr(), compact.data_ptr(),
               dst.data_ptr(), None if src is None else src.data_ptr(), dst.shape[0],
               dest.shape[1] * dest.element_size(), build.stream_of(dest))
