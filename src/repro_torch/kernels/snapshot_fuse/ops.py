"""Dispatch wrappers for the fused snapshot data plane.

``fused_publish``   — one sweep, one launch: zero bitmap + poly32 checksum
                      + hot/cold compaction.  Plugs into ``build_snapshot``
                      via the ``publish_fn`` seam (``make_fused_publish_fn``).
``fused_restore_rows`` — one kernel over a row list (``rows.py``): gather
                      rows from any number of source tensors → checksum →
                      verify against a guest-indexed table → scatter into
                      the guest frame, in place; or verify only.
``fused_restore``   — the same for one source tensor.
``FusedScatter``    — ``fused_restore`` adapted to the serving layer's
                      in-place ``ScatterFn`` signature ``(dest, compact,
                      indices, src_indices=None)``; optionally bound to a
                      snapshot's publish-time checksum table, in which case
                      every installed page is verified on the device in the
                      same launch that installs it.  Its batched form
                      ``scatter_rows(dest, segments)`` installs a whole
                      restore walk in one launch.

Dispatch is by the device of the tensors: CPU tensors take the plain torch
version in ``ref.py``; CUDA tensors launch the hand-written kernel or raise.
There is no fallback from one to the other.  Each wrapper counts its kernel
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch

from .. import launch_count, rows
from ..page_checksum.ops import weights_on
from . import kernel
from .ref import fused_publish_ref, fused_restore_rows_ref

PAGE_BYTES = 4096  # the kernels' row width: one 4 KiB guest page
PUBLISH_TILE_PAGES = 64  # pages a tile of the publish kernel (csrc/fused_publish.cu kTilePages)
PUBLISH_MAX_PAGES = 2**31 - 1  # the kernel's tile status words count pages in 31 bits


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


def publish_rows(buf: torch.Tensor, n_ws: int, n_hot: int, n_cold: int):
    """``(hot, cold)`` as views of the publish kernel's one output ``buf``:
    hot rows start at row 0, cold rows at row ``n_ws`` (the working set's
    size, which bounds ``n_hot``)."""
    return buf[:n_hot], buf[n_ws:n_ws + n_cold]


def fused_publish(pages: torch.Tensor, ws_mask: torch.Tensor) -> FusedPublishResult:
    """pages: (N, page_bytes) uint8; ws_mask: bool[N] working set (same device).

    On the card: one launch of the one-pass kernel.  The working set's size
    is read before it, the two counts after it; ``hot`` and ``cold`` are
    views of one ``(N, page_bytes)`` buffer, ``zero_bitmap`` and
    ``checksums`` allocations of their own (a snapshot keeps the checksums
    for its life, and must not pin the page buffer with them)."""
    if pages.device.type == "cpu":
        return FusedPublishResult(*fused_publish_ref(pages, ws_mask))
    n = pages.shape[0]
    if n > PUBLISH_MAX_PAGES:
        raise ValueError(f"fused_publish: {n} pages, the kernel takes at most "
                         f"{PUBLISH_MAX_PAGES}")
    _check_rows("fused_publish pages", pages)
    dev = pages.device
    ws = ws_mask.to(device=dev, dtype=torch.bool).contiguous()
    if ws.shape != (n,):
        raise ValueError(f"fused_publish: ws_mask shape {tuple(ws.shape)} != ({n},)")
    zero = torch.empty(n, dtype=torch.bool, device=dev)
    csum = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        empty = torch.empty((0, PAGE_BYTES), dtype=torch.uint8, device=dev)
        return FusedPublishResult(zero, csum, empty, empty.clone())
    n_ws = int(ws.sum())                    # sizes the cold rows' base, before the launch
    buf = torch.empty((n, PAGE_BYTES), dtype=torch.uint8, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    tiles = -(-n // PUBLISH_TILE_PAGES)
    scratch = torch.empty(1 + tiles, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        kernel.publish(pages, ws, _weights(dev), n_ws, PUBLISH_TILE_PAGES, zero, csum, buf,
                       counts, scratch)
    launch_count.count(fused_publish)
    n_hot, n_cold = counts.tolist()         # after the launch: the views' lengths
    return FusedPublishResult(zero, csum, *publish_rows(buf, n_ws, n_hot, n_cold))


fused_publish.launches = 0

# build_snapshot's publish_fn seam: (pages_matrix uint8[N, PAGE_SIZE],
# ws bool[N]) -> FusedPublishResult
PublishFn = Callable[[torch.Tensor, torch.Tensor], FusedPublishResult]


def make_fused_publish_fn() -> PublishFn:
    def publish_fn(pages_matrix: torch.Tensor, ws: torch.Tensor) -> FusedPublishResult:
        return fused_publish(pages_matrix, ws)

    return publish_fn


def fused_restore_rows(dest: Optional[torch.Tensor], segments,
                       expected_table: Optional[torch.Tensor] = None,
                       verify_only: bool = False) -> torch.Tensor:
    """Install every row of the row list ``segments`` (``(tensor, rows, dst)``
    with host arrays, ``rows`` None: ``arange``) at ``dest[dst]`` in place, in
    ONE launch on the card, and return the rows' checksums (int32[M], list
    order).  Destinations must be unique across the segments.

    With ``expected_table`` (int32, guest-page-indexed, on the rows' device)
    each row is verified against ``expected_table[dst]`` and
    :class:`ChecksumMismatchError` lists the guest pages that disagree; the
    rows are written either way.  ``verify_only`` checksums and verifies
    without writing (``dest`` may then be None; ``dst`` indexes the table)."""
    if verify_only:
        dest = None
    elif dest is None:
        raise ValueError("fused_restore_rows: dest is None and verify_only is not set")
    if dest is not None:
        bound, device = dest.shape[0], dest.device
    elif expected_table is not None:
        bound, device = expected_table.shape[0], expected_table.device
    else:
        raise ValueError("fused_restore_rows: a verify-only launch needs expected_table")
    segs, dst, addr = rows.check_segments("fused_restore", segments, PAGE_BYTES, bound)
    for t, _r, _d in segs:
        if t.dtype != torch.uint8 or t.device != device:
            raise ValueError(f"fused_restore: expected uint8 rows on {device}, got "
                             f"{t.dtype} on {t.device}")
    if expected_table is not None and (expected_table.device != device
                                       or expected_table.dtype != torch.int32):
        raise ValueError("fused_restore: expected_table must be int32 on the rows' device")
    m = dst.size
    if device.type == "cpu":
        csum = fused_restore_rows_ref(dest, segs)
        if m and expected_table is not None:
            bad = (csum != expected_table[torch.from_numpy(dst)]).numpy()
            if bad.any():
                raise ChecksumMismatchError(dst[bad])
        return csum
    if m == 0:
        return torch.zeros(0, dtype=torch.int32, device=device)
    if dest is not None:
        _check_rows("fused_restore dest", dest)
    idx = rows.upload([addr, dst], device)
    csum = torch.empty(m, dtype=torch.int32, device=device)
    bad = n_bad = None
    if expected_table is not None:
        bad = torch.empty(m, dtype=torch.uint8, device=device)
        n_bad = torch.empty(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        kernel.restore_rows(dest, 0, 1, idx[0], idx[1], _weights(device), expected_table, csum,
                            bad, n_bad)
    launch_count.count(fused_restore)
    if n_bad is not None and int(n_bad.item()) > 0:   # bad indices cross only on a mismatch
        raise ChecksumMismatchError(dst[bad.cpu().numpy().astype(bool)])
    return csum


def fused_restore(dest: torch.Tensor, compact: torch.Tensor, indices,
                  *, src_indices=None, expected_table: Optional[torch.Tensor] = None):
    """Install ``compact[src_indices[i]]`` at ``dest[indices[i]]`` in place and
    return ``(dest, csums int32[M])``: :func:`fused_restore_rows` of one
    segment.

    ``indices`` / ``src_indices`` are host integer arrays (``src_indices``
    defaults to ``arange(M)``); ``indices`` must be unique.  With
    ``expected_table`` (int32, guest-page-indexed, on ``dest``'s device) each
    row is verified against ``expected_table[indices[i]]`` and
    :class:`ChecksumMismatchError` lists the guest pages that disagree.  The
    rows are written either way.
    """
    if src_indices is None:
        src_indices = np.arange(np.asarray(indices).size, dtype=np.int64)
    csum = fused_restore_rows(dest, [(compact, src_indices, indices)],
                              expected_table=expected_table)
    return dest, csum


fused_restore.launches = 0


_STATS_LOCK = threading.Lock()


class FusedScatter:
    """In-place ``ScatterFn`` over :func:`fused_restore`.

    Drop-in for the serving layer's scatter seam (``Instance``,
    ``RestoreEngine``).  When bound to a snapshot's guest-indexed publish-time
    checksum table (:meth:`bind_checksums` — ``RestoreEngine.__init__`` does
    this when the reader's regions carry one), every batch is verified
    against ``table[indices]`` inside the launch that installs it.  Bound
    copies share the template's ``stats`` dict.

    The batched form: :meth:`count_batch` accounts a logical batch whose
    rows are queued (:meth:`uncount_batch` takes it back when a flush
    repairs it), :meth:`scatter_rows` installs (and verifies) all the
    queued rows in one launch, and :meth:`verify_rows` checks source rows
    against the table without installing them.
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

    def _table_on(self, device: torch.device) -> Optional[torch.Tensor]:
        if self.expected is not None and self.expected.device != device:
            self.expected = self.expected.to(device)
        return self.expected

    def count_batch(self, n: int) -> None:
        """Account one logical batch of ``n`` pages (installed or queued).
        Restores of one orchestrator share a template's ``stats`` and
        install from several threads, so the counts take a lock."""
        with _STATS_LOCK:
            self.stats["batches"] += 1
            self.stats["pages"] += int(n)
            if self.expected is not None:
                self.stats["pages_verified"] += int(n)

    def uncount_batch(self, n: int) -> None:
        """Take back :meth:`count_batch` of a queued batch that is installed
        again (a walk's flush repairing a mismatch)."""
        with _STATS_LOCK:
            self.stats["batches"] -= 1
            self.stats["pages"] -= int(n)
            if self.expected is not None:
                self.stats["pages_verified"] -= int(n)

    def __call__(self, dest: torch.Tensor, compact: torch.Tensor, indices,
                 src_indices=None) -> None:
        idx = np.asarray(indices, dtype=np.int64).reshape(-1)
        fused_restore(dest, compact, idx, src_indices=src_indices,
                      expected_table=self._table_on(dest.device))
        self.count_batch(idx.size)

    def scatter_rows(self, dest: torch.Tensor, segments) -> torch.Tensor:
        """Install the row list ``segments`` in one launch, verified against
        the bound table (batches were accounted when queued)."""
        return fused_restore_rows(dest, segments, expected_table=self._table_on(dest.device))

    def verify_rows(self, segments) -> bool:
        """Whether every row of ``segments`` (``dst`` = guest pages) matches
        the bound table: one verify-only launch and one read-back."""
        if not segments:
            return True
        try:
            fused_restore_rows(None, segments, expected_table=self._table_on(
                segments[0][0].device), verify_only=True)
        except ChecksumMismatchError:
            return False
        return True
