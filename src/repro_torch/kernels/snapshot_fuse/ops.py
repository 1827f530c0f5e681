"""Dispatch wrappers for the fused snapshot data plane.

``fused_publish``   — one sweep: zero bitmap + poly32 checksum + hot/cold
                      compaction.  Plugs into ``build_snapshot`` via the
                      ``publish_fn`` seam (``make_fused_publish_fn``).
``fused_restore``   — one kernel: gather-from-chunk → checksum-verify →
                      scatter-into-guest-frame, in place.
``FusedScatter``    — ``fused_restore`` adapted to the serving layer's
                      in-place ``ScatterFn`` signature ``(dest, compact,
                      indices, src_indices=None)``; optionally bound to a
                      snapshot's publish-time checksum table, in which case
                      every installed page is verified on the device in the
                      same launch that installs it.

Dispatch is by the device of the tensors: CPU tensors take the plain torch
version in ``ref.py``; CUDA tensors launch the hand-written kernel or raise.
There is no fallback from one to the other.  Each wrapper counts its kernel
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import rows
from ..page_checksum.ops import weights_on
from . import kernel
from .ref import fused_publish_ref, fused_restore_ref

PAGE_BYTES = 4096  # the kernels' row width: one 4 KiB guest page


class ChecksumMismatchError(RuntimeError):
    """A restored page's checksum disagreed with the publish-time record.

    ``bad_pages`` is the structured payload — a 1-D int64 array of the
    failing GUEST page indices — which the serving layer's checksum-repair
    path consumes.  The message stays human-readable and truncated no matter
    how many pages failed.
    """

    MAX_SHOWN = 8

    def __init__(self, pages: np.ndarray):
        self.bad_pages = np.atleast_1d(
            np.asarray(pages, dtype=np.int64)).reshape(-1)
        shown = self.bad_pages[: self.MAX_SHOWN].tolist()
        extra = self.bad_pages.size - len(shown)
        super().__init__(
            f"checksum mismatch on {self.bad_pages.size} restored page(s): "
            f"{shown}{f' (+{extra} more)' if extra > 0 else ''}")


@dataclasses.dataclass
class FusedPublishResult:
    """One publish sweep's outputs (tensors on the pages' device), guest-page
    order throughout."""

    zero_bitmap: torch.Tensor   # bool[N]
    checksums: torch.Tensor     # int32[N] holding the uint32 poly32 bits
    hot: torch.Tensor           # uint8[n_hot, page_bytes], ascending page order
    cold: torch.Tensor          # uint8[n_cold, page_bytes], ascending page order


def _weights(device: torch.device) -> torch.Tensor:
    """poly32 weights for a 4 KiB page as an int32 tensor on ``device``."""
    return weights_on(device, PAGE_BYTES // 4)


def _check_rows(name: str, t: torch.Tensor) -> None:
    """What the CUDA kernels take: contiguous uint8 (rows, 4096), 16-byte aligned."""
    if t.dtype != torch.uint8 or t.dim() != 2 or t.shape[1] != PAGE_BYTES:
        raise ValueError(f"{name}: expected uint8 (rows, {PAGE_BYTES}), got "
                         f"{t.dtype} {tuple(t.shape)}")
    rows.check_rows(name, t)


def fused_publish(pages: torch.Tensor, ws_mask: torch.Tensor) -> FusedPublishResult:
    """pages: (N, page_bytes) uint8; ws_mask: bool[N] working set (same device)."""
    if pages.device.type == "cpu":
        return FusedPublishResult(*fused_publish_ref(pages, ws_mask))
    _check_rows("fused_publish pages", pages)
    n = pages.shape[0]
    dev = pages.device
    ws = ws_mask.to(device=dev, dtype=torch.bool).contiguous()
    if ws.shape != (n,):
        raise ValueError(f"fused_publish: ws_mask shape {tuple(ws.shape)} != ({n},)")
    if n == 0:
        empty = torch.empty((0, PAGE_BYTES), dtype=torch.uint8, device=dev)
        return FusedPublishResult(torch.empty(0, dtype=torch.bool, device=dev),
                                  torch.empty(0, dtype=torch.int32, device=dev),
                                  empty, empty.clone())
    zero = torch.empty(n, dtype=torch.bool, device=dev)
    csum = torch.empty(n, dtype=torch.int32, device=dev)
    cls = torch.empty(n, dtype=torch.uint8, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        kernel.publish_classify(pages, ws, _weights(dev), zero, csum, cls, pos, counts)
        fused_publish.launches += 1
        n_hot, n_cold = counts.tolist()     # the one read-back: sizes the outputs
        hot = torch.empty((n_hot, PAGE_BYTES), dtype=torch.uint8, device=dev)
        cold = torch.empty((n_cold, PAGE_BYTES), dtype=torch.uint8, device=dev)
        kernel.publish_compact(pages, cls, pos, hot, cold)
    return FusedPublishResult(zero, csum, hot, cold)


fused_publish.launches = 0

# build_snapshot's publish_fn seam: (pages_matrix uint8[N, PAGE_SIZE],
# ws bool[N]) -> FusedPublishResult
PublishFn = Callable[[torch.Tensor, torch.Tensor], FusedPublishResult]


def make_fused_publish_fn() -> PublishFn:
    def publish_fn(pages_matrix: torch.Tensor, ws: torch.Tensor) -> FusedPublishResult:
        return fused_publish(pages_matrix, ws)

    return publish_fn


def fused_restore(dest: torch.Tensor, compact: torch.Tensor, indices,
                  *, src_indices=None, expected_table: Optional[torch.Tensor] = None):
    """Install ``compact[src_indices[i]]`` at ``dest[indices[i]]`` in place and
    return ``(dest, csums int32[M])``.

    ``indices`` / ``src_indices`` are host integer arrays (``src_indices``
    defaults to ``arange(M)``); ``indices`` must be unique.  With
    ``expected_table`` (int32, guest-page-indexed, on ``dest``'s device) each
    row is verified against ``expected_table[indices[i]]`` and
    :class:`ChecksumMismatchError` lists the guest pages that disagree.  The
    rows are written either way.
    """
    dst = rows.host_indices("fused_restore", indices, dest.shape[0])
    m = dst.size
    src = (np.arange(m, dtype=np.int64) if src_indices is None
           else rows.host_indices("fused_restore src", src_indices, compact.shape[0]))
    if src.size != m:
        raise ValueError(f"fused_restore: {src.size} sources for {m} destinations")
    if m == 0:
        return dest, torch.zeros(0, dtype=torch.int32, device=dest.device)
    rows.check_unique("fused_restore", dst)
    idx = torch.from_numpy(np.stack([src, dst])).to(dest.device)   # one host→device copy
    if dest.device.type == "cpu":
        csum = fused_restore_ref(dest, compact, idx[0], idx[1])
        bad = (None if expected_table is None
               else (csum != expected_table[idx[1]]).numpy())
        if bad is not None and bad.any():
            raise ChecksumMismatchError(dst[bad])
        return dest, csum
    _check_rows("fused_restore dest", dest)
    _check_rows("fused_restore compact", compact)
    if expected_table is not None and (expected_table.device != dest.device
                                       or expected_table.dtype != torch.int32):
        raise ValueError("fused_restore: expected_table must be int32 on dest's device")
    csum = torch.empty(m, dtype=torch.int32, device=dest.device)
    n_bad = None if expected_table is None else torch.empty(1, dtype=torch.int32,
                                                            device=dest.device)
    with torch.cuda.device(dest.device):
        kernel.restore(dest, compact, idx[0], idx[1], _weights(dest.device),
                       expected_table, csum, n_bad)
    fused_restore.launches += 1
    if n_bad is not None and int(n_bad.item()) > 0:   # bad indices cross only on a mismatch
        bad = (csum != expected_table[idx[1]]).cpu().numpy()
        raise ChecksumMismatchError(dst[bad])
    return dest, csum


fused_restore.launches = 0


class FusedScatter:
    """In-place ``ScatterFn`` over :func:`fused_restore`.

    Drop-in for the serving layer's scatter seam (``Instance``,
    ``RestoreEngine``).  When bound to a snapshot's guest-indexed publish-time
    checksum table (:meth:`bind_checksums` — ``RestoreEngine.__init__`` does
    this when the reader's regions carry one), every batch is verified
    against ``table[indices]`` inside the launch that installs it.  Bound
    copies share the template's ``stats`` dict.
    """

    def __init__(self, *, expected: Optional[torch.Tensor] = None,
                 stats: Optional[dict] = None):
        self.expected = expected
        self.stats = stats if stats is not None else {
            "batches": 0, "pages": 0, "pages_verified": 0}

    def bind_checksums(self, table) -> "FusedScatter":
        """Bound copy; ``table`` is an int32 tensor of uint32 bits, or a host
        uint32 array."""
        if not isinstance(table, torch.Tensor):
            table = torch.from_numpy(np.asarray(table, dtype=np.uint32).view(np.int32))
        return FusedScatter(expected=table, stats=self.stats)

    def __call__(self, dest: torch.Tensor, compact: torch.Tensor, indices,
                 src_indices=None) -> None:
        idx = np.asarray(indices, dtype=np.int64).reshape(-1)
        if self.expected is not None and self.expected.device != dest.device:
            self.expected = self.expected.to(dest.device)
        fused_restore(dest, compact, idx, src_indices=src_indices,
                      expected_table=self.expected)
        self.stats["batches"] += 1
        self.stats["pages"] += int(idx.size)
        if self.expected is not None:
            self.stats["pages_verified"] += int(idx.size)
