"""Dispatch wrapper for the per-page poly32 checksum.

``page_checksum(pages)`` returns int32[N] holding the uint32 checksum bits of
each row (any dtype, read as its bytes).  CPU tensors take the plain version
(``ref.py``); CUDA tensors launch the hand-written kernel or raise.
``page_checksum.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import launch_count, rows
from . import kernel
from .ref import page_checksum_ref, poly_weights

_weights_cache: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def weights_on(device: torch.device, lanes: int) -> torch.Tensor:
    """poly32 weights for rows of ``lanes`` uint32 lanes, as an int32 tensor
    on ``device`` (cached)."""
    w = _weights_cache.get((device, lanes))
    if w is None:
        w = torch.from_numpy(poly_weights(lanes).view(np.int32)).to(device)
        _weights_cache[(device, lanes)] = w
    return w


def page_checksum(pages: torch.Tensor) -> torch.Tensor:
    """pages: (N, row) rows of a multiple of 4 bytes -> int32[N] poly32 bits."""
    if pages.dim() != 2:
        raise ValueError(f"page_checksum: expected (N, row), got {tuple(pages.shape)}")
    if pages.dtype != torch.uint8:
        pages = pages.view(torch.uint8)
    if pages.shape[1] % 4:
        raise ValueError(f"page_checksum: rows of {pages.shape[1]} bytes are not uint32 lanes")
    if pages.device.type == "cpu":
        return page_checksum_ref(pages)
    rows.check_rows("page_checksum pages", pages)
    out = torch.empty(pages.shape[0], dtype=torch.int32, device=pages.device)
    if pages.shape[0]:
        with torch.cuda.device(pages.device):
            kernel.page_checksum(pages, weights_on(pages.device, pages.shape[1] // 4), out)
        launch_count.count(page_checksum)
    return out


page_checksum.launches = 0
