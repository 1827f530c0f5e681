"""Checks and index handling shared by the page-row kernels' wrappers.

The row kernels (``zero_detect``, ``page_checksum``, ``page_gather``,
``page_scatter``, ``fused_restore``) read and write 2-D tensors row by row in
16-byte words, so a CUDA tensor they take must be contiguous, 16-byte
aligned and a multiple of 16 bytes wide; the wrappers raise on anything
else.  Indices come either as host integer arrays, which are range-checked
here and copied to the card once, or as integer tensors already on the
tensor's device, which are taken as they are (no check, no copy).

A *row list* is what the batched scatter and restore kernels take: a list
of segments ``(tensor, rows, dst)``, each saying that row ``rows[k]`` of the
2-D ``tensor`` (``rows`` None: row ``k``) goes to destination row
``dst[k]``.  :func:`check_segments` range-checks them on the host and
turns them into one int64 array of source byte addresses, so one launch
takes rows from any number of tensors.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# (source tensor, host row indices or None, host destination rows)
Segment = Tuple[torch.Tensor, Optional[np.ndarray], np.ndarray]


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


def check_unique(name: str, idx: np.ndarray) -> None:
    """Debug-mode check that host destination rows are unique (parallel
    writes to one row would race)."""
    if __debug__:
        assert np.unique(idx).size == idx.size, f"{name}: duplicate destination rows"


def upload(arrays: Sequence[np.ndarray], device: torch.device) -> torch.Tensor:
    """Host int64 arrays of one length as one ``(k, M)`` int64 tensor on
    ``device``: one pinned, non-blocking host-to-device copy."""
    host = torch.from_numpy(np.stack([np.asarray(a, dtype=np.int64) for a in arrays]))
    return host.pin_memory().to(device, non_blocking=True)


def check_segments(name: str, segments: Sequence[Segment], row_bytes: int,
                   dst_bound: int) -> Tuple[List[Segment], np.ndarray, np.ndarray]:
    """Check a row list on the host, vectorized over its rows.

    Every source tensor must be 2-D with rows of ``row_bytes`` bytes
    (contiguous and 16-byte aligned on the card); ``rows`` (None: ``arange``,
    the tensor's every row) and ``dst`` are range-checked, and destinations
    are checked unique across all the segments in debug mode.  Returns the
    segments with int64 host ``rows`` and ``dst``, all destinations
    concatenated, and every row's source byte address in the same order."""
    ts, rs, ds = [], [], []
    for t, r, d in segments:
        if t.dim() != 2 or t.shape[1] * t.element_size() != row_bytes:
            raise ValueError(f"{name}: a source of shape {tuple(t.shape)} {t.dtype} does not "
                             f"hold rows of {row_bytes} bytes")
        if t.device.type == "cuda":
            check_rows(name, t)
        d = np.asarray(d, dtype=np.int64).reshape(-1)
        if r is None:
            if t.shape[0] != d.size:
                raise ValueError(f"{name}: {t.shape[0]} source rows for {d.size} destinations")
            r = np.arange(d.size, dtype=np.int64)
        else:
            r = np.asarray(r, dtype=np.int64).reshape(-1)
            if r.size != d.size:
                raise ValueError(f"{name}: {r.size} sources for {d.size} destinations")
        ts.append(t)
        rs.append(r)
        ds.append(d)
    if not ts:
        empty = np.zeros(0, dtype=np.int64)
        return [], empty, empty
    lens = np.fromiter((d.size for d in ds), np.int64, len(ds))
    dst, src = np.concatenate(ds), np.concatenate(rs)
    if dst.size:
        if dst.min() < 0 or dst.max() >= dst_bound:
            raise IndexError(f"{name}: row index out of range [0, {dst_bound})")
        n_rows = np.repeat(np.fromiter((t.shape[0] for t in ts), np.int64, len(ts)), lens)
        if src.min() < 0 or (src >= n_rows).any():
            raise IndexError(f"{name}: a source row out of range of its tensor")
        check_unique(name, dst)
    base = np.repeat(np.fromiter((t.data_ptr() for t in ts), np.int64, len(ts)), lens)
    return list(zip(ts, rs, ds)), dst, base + src * row_bytes
