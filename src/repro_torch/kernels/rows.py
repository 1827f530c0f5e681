"""Checks and index handling shared by the page-row kernels' wrappers.

The row kernels (``zero_detect``, ``page_checksum``, ``page_gather``,
``page_scatter``) read and write 2-D tensors row by row in 16-byte words, so
a CUDA tensor they take must be contiguous, 16-byte aligned and a multiple of
16 bytes wide; the wrappers raise on anything else.  Indices come either as
host integer arrays, which are range-checked here and copied to the card
once, or as integer tensors already on the tensor's device, which are taken
as they are (no check, no copy).
"""
from __future__ import annotations

import numpy as np
import torch


def check_rows(name: str, t: torch.Tensor) -> None:
    """What the row kernels take: a contiguous 2-D CUDA tensor whose rows are
    a multiple of 16 bytes wide, 16-byte aligned."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dim() != 2:
        raise ValueError(f"{name}: expected 2-D rows, got shape {tuple(t.shape)}")
    if (t.shape[1] * t.element_size()) % 16 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be contiguous, 16-byte aligned and a "
                         f"multiple of 16 bytes wide (got {tuple(t.shape)} {t.dtype})")


def host_indices(name: str, idx, bound: int) -> np.ndarray:
    """A host integer array as int64, every entry in ``[0, bound)``."""
    out = np.asarray(idx, dtype=np.int64).reshape(-1)
    if out.size and (out.min() < 0 or out.max() >= bound):
        raise IndexError(f"{name}: row index out of range [0, {bound})")
    return out


def as_index_tensor(name: str, idx, bound: int, device: torch.device) -> torch.Tensor:
    """``idx`` as an int64 tensor on ``device``.  A tensor already there is
    taken as it is; anything else goes through :func:`host_indices` and one
    host-to-device copy."""
    if isinstance(idx, torch.Tensor) and idx.device == device:
        return idx.reshape(-1).to(torch.int64)
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    return torch.from_numpy(host_indices(name, idx, bound)).to(device)


def check_unique(name: str, idx) -> None:
    """Debug-mode check that host destination rows are unique (parallel
    writes to one row would race)."""
    if not __debug__:
        return
    if isinstance(idx, torch.Tensor):
        if idx.device.type != "cpu":
            return
        idx = idx.numpy()
    arr = np.asarray(idx).reshape(-1)
    assert np.unique(arr).size == arr.size, f"{name}: duplicate destination rows"
