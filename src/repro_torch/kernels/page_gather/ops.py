"""Dispatch wrapper for the row gather.

``page_gather(pages, indices)`` returns ``pages[indices]`` as a new (M, E)
tensor.  ``indices`` is a host integer array (range-checked, copied to the
card once) or an int64 tensor already on ``pages``' device.  CPU tensors
take the plain version (``ref.py``); CUDA tensors launch the hand-written
kernel or raise.  ``page_gather.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import launch_count, rows
from . import kernel
from .ref import page_gather_ref


def page_gather(pages: torch.Tensor, indices) -> torch.Tensor:
    """pages: (N, E); indices: M row numbers -> (M, E) of pages' dtype."""
    if pages.dim() != 2:
        raise ValueError(f"page_gather: expected (N, E), got {tuple(pages.shape)}")
    idx = rows.as_index_tensor("page_gather", indices, pages.shape[0], pages.device)
    if pages.device.type == "cpu":
        return page_gather_ref(pages, idx)
    rows.check_rows("page_gather pages", pages)
    out = torch.empty((idx.shape[0], pages.shape[1]), dtype=pages.dtype, device=pages.device)
    if idx.shape[0]:
        with torch.cuda.device(pages.device):
            kernel.page_gather(pages, idx, out)
        launch_count.count(page_gather)
    return out


page_gather.launches = 0
