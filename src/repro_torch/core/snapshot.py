"""Hotness-based snapshot format (§3.2), private layout.

A snapshot of a paged ``StateImage`` is stored as:

* **offset array** — one ``uint64`` slot per guest page.
    - sentinel ``0xFFFF_FFFF_FFFF_FFFF`` → zero page (not stored at all);
    - top 2 bits → memory-backend tag (``TIER_CXL`` / ``TIER_RDMA``);
    - low 62 bits → byte offset of the page *within that tier's data region*.
* **hot data region** (CXL tier) — compacted content of hot pages.
* **cold data region** (RDMA tier) — compacted content of cold pages.
* **machine state** (CXL tier) — serialized manifest + metadata, needed to
  resume without touching the RDMA tier.

CXL-region layout (all sections page-aligned):
    [ machine_state | offset_array | hot page data ]

Page bytes stay on the pool's device; the offset array, page classes and run
index are host numpy (read back from the device once).  The zstd-compressed
cold tier, the content-addressed (dedup) layout and re-curation are not in
this package yet: they raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .faults import TierFaultError
from .pagestore import PAGE_SIZE, Manifest, StateImage, num_pages
from .pool import TIER_CXL, TIER_RDMA, HierarchicalPool, HostView, MemoryTier

ZERO_SENTINEL = np.uint64(0xFFFF_FFFF_FFFF_FFFF)
TIER_SHIFT = np.uint64(62)
OFFSET_MASK = np.uint64((1 << 62) - 1)

_DEDUP_TODO = "dedup snapshot layout is not ported yet (ROADMAP A4b)"
_ZSTD_TODO = "compress_cold (zstd cold tier) is not ported yet (ROADMAP A4b)"
_RECURATE_TODO = "plan_recuration is not ported yet (ROADMAP A4c)"


def encode_slot(tier: int, offset: int) -> np.uint64:
    return (np.uint64(tier) << TIER_SHIFT) | np.uint64(offset)


def decode_slot(slot: np.uint64) -> Tuple[int, int]:
    return int(slot >> TIER_SHIFT), int(slot & OFFSET_MASK)


def _align_pages(nbytes: int) -> int:
    return num_pages(nbytes) * PAGE_SIZE


def runs_of_indices(idx: np.ndarray) -> np.ndarray:
    """Vectorized run-length encoding of a sorted index array.

    Returns an ``int64 (R, 2)`` array of ``[start, length]`` rows covering
    exactly the input set.
    """
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    brk = np.nonzero(np.diff(idx) != 1)[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk, [idx.size - 1]])
    return np.stack([idx[starts], ends - starts + 1], axis=1)


def _to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host bytes (any dtype) as a 1-D uint8 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(host).view(np.uint8).reshape(-1)).to(device)


# --------------------------------------------------------------------------
# Page classification (§2.3.3 semantics)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PageClasses:
    """Partition of an image's pages into zero / hot / cold classes."""

    zero_bitmap: np.ndarray       # bool[total_pages]
    hot_pages: np.ndarray         # sorted int64 page indices (non-zero ∩ working set)
    cold_pages: np.ndarray        # sorted int64 page indices (non-zero ∖ working set)

    @property
    def n_zero(self) -> int:
        return int(self.zero_bitmap.sum())

    def summary(self) -> Dict[str, int]:
        return {
            "total": int(self.zero_bitmap.size),
            "zero": self.n_zero,
            "hot": int(self.hot_pages.size),
            "cold": int(self.cold_pages.size),
        }


def _ws_bool(image: StateImage, working_set: Sequence[int]) -> np.ndarray:
    ws = np.zeros(image.total_pages, dtype=bool)
    if len(working_set):
        ws[np.asarray(sorted(set(working_set)), dtype=np.int64)] = True
    return ws


def classify_pages(
    image: StateImage,
    working_set: Sequence[int],
    zero_bitmap: Optional[np.ndarray] = None,
) -> PageClasses:
    """Partition the image's pages into zero / hot / cold (§3.2).

    hot  = recorded working set, minus pages whose content is zero
    cold = non-zero pages not in the working set
    """
    if zero_bitmap is None:
        zero_bitmap = image.zero_page_bitmap()
    ws = _ws_bool(image, working_set)
    nonzero = ~zero_bitmap
    hot = np.nonzero(nonzero & ws)[0].astype(np.int64)
    cold = np.nonzero(nonzero & ~ws)[0].astype(np.int64)
    return PageClasses(zero_bitmap, hot, cold)


# --------------------------------------------------------------------------
# Stored snapshot
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SnapshotRegions:
    """Where one snapshot's sections live inside the pool tiers.

    Field for field the reference package's record, so a record published
    there round-trips through ``to_dict`` / ``from_dict``.
    """

    name: str
    version: int
    # CXL region
    cxl_off: int
    cxl_size: int
    ms_size: int                  # machine-state section bytes (aligned)
    oa_size: int                  # offset-array section bytes (aligned)
    hot_bytes: int                # hot data payload bytes
    # RDMA region
    rdma_off: int
    rdma_size: int
    cold_bytes: int
    total_pages: int
    n_hot: int
    n_cold: int
    n_zero: int
    # zstd cold tier and dedup layout: always off in this package
    cold_compressed: bool = False
    ci_size: int = 0
    cold_raw_bytes: int = 0       # uncompressed cold payload
    dedup: bool = False

    @property
    def ms_off(self) -> int:
        return self.cxl_off

    @property
    def oa_off(self) -> int:
        return self.cxl_off + self.ms_size

    @property
    def ci_off(self) -> int:
        return self.cxl_off + self.ms_size + self.oa_size

    @property
    def hot_off(self) -> int:
        return self.cxl_off + self.ms_size + self.oa_size + self.ci_size

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SnapshotRegions":
        return SnapshotRegions(**d)


def _check_private(regions: SnapshotRegions) -> None:
    if regions.dedup:
        raise NotImplementedError(_DEDUP_TODO)
    if regions.cold_compressed:
        raise NotImplementedError(_ZSTD_TODO)


def _serialize_machine_state(manifest: Manifest, metadata: dict) -> bytes:
    blob = json.dumps({"manifest": manifest.to_dict(), "metadata": metadata}).encode()
    return len(blob).to_bytes(8, "little") + blob


def _deserialize_machine_state(raw: np.ndarray) -> Tuple[Manifest, dict]:
    n = int.from_bytes(raw[:8].tobytes(), "little")
    d = json.loads(raw[8 : 8 + n].tobytes().decode())
    return Manifest.from_dict(d["manifest"]), d["metadata"]


def _run_publish_fn(publish_fn, image: StateImage, working_set: Sequence[int]):
    """One fused sweep (kernels/snapshot_fuse) in place of the piecemeal
    zero-scan → hash → gather×2 pipeline: returns ``(classes, hot_mat,
    cold_mat, checksums int32[total_pages])``, the matrices and checksums on
    the image's device.  The zero bitmap crosses to the host once."""
    ws = _ws_bool(image, working_set)
    res = publish_fn(image.pages_matrix(), torch.from_numpy(ws).to(image.device))
    zero_bitmap = res.zero_bitmap.cpu().numpy().astype(bool)
    nonzero = ~zero_bitmap
    hot = np.nonzero(nonzero & ws)[0].astype(np.int64)
    cold = np.nonzero(nonzero & ~ws)[0].astype(np.int64)
    classes = PageClasses(zero_bitmap, hot, cold)
    return classes, res.hot, res.cold, res.checksums


def _gather_rows(mat: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return mat[torch.from_numpy(idx).to(mat.device)]


def build_snapshot(
    pool: HierarchicalPool,
    image: StateImage,
    working_set: Sequence[int],
    name: str,
    version: int = 0,
    metadata: Optional[dict] = None,
    zero_bitmap: Optional[np.ndarray] = None,
    gather_fn=None,
    compress_cold: bool = False,
    dedup: bool = False,
    publish_fn=None,
) -> SnapshotRegions:
    """Write one snapshot into the pool tiers; returns its region record.

    ``gather_fn(pages_matrix, page_indices) -> compact`` swaps the row
    gather (default: torch indexing).  ``publish_fn(pages_matrix, ws_bool)
    -> FusedPublishResult`` goes further: the fused single-sweep kernel
    replaces the zero scan, the checksum AND both gathers in one pass; its
    per-page checksum column is recorded on the returned regions (in-memory
    ``page_checksums`` attribute, guest-page-indexed int32 tensor on the
    device) so restores can verify installed pages against publish-time
    content.  When set it supersedes ``zero_bitmap``/``gather_fn``.
    """
    if dedup:
        raise NotImplementedError(_DEDUP_TODO)
    if compress_cold:
        raise NotImplementedError(_ZSTD_TODO)
    checksums = None
    if publish_fn is not None:
        classes, hot_mat, cold_mat, checksums = _run_publish_fn(
            publish_fn, image, working_set)
    else:
        classes = classify_pages(image, working_set, zero_bitmap)
        gather = gather_fn or _gather_rows
        mat = image.pages_matrix()
        hot_mat = gather(mat, classes.hot_pages) if classes.hot_pages.size else None
        cold_mat = gather(mat, classes.cold_pages) if classes.cold_pages.size else None
    hot, cold = classes.hot_pages, classes.cold_pages
    hot_nbytes = int(hot.size) * PAGE_SIZE
    cold_nbytes = int(cold.size) * PAGE_SIZE

    # Offset array: slot per guest page (byte offset within the tier region).
    oa = np.full(image.total_pages, ZERO_SENTINEL, dtype=np.uint64)
    if hot.size:
        oa[hot] = (np.uint64(TIER_CXL) << TIER_SHIFT) | (
            np.arange(hot.size, dtype=np.uint64) * np.uint64(PAGE_SIZE)
        )
    if cold.size:
        oa[cold] = (np.uint64(TIER_RDMA) << TIER_SHIFT) | (
            np.arange(cold.size, dtype=np.uint64) * np.uint64(PAGE_SIZE)
        )

    ms = _serialize_machine_state(image.manifest, metadata or {})
    ms_size = _align_pages(len(ms))
    oa_size = _align_pages(oa.nbytes)
    hot_size = _align_pages(hot_nbytes) if hot_nbytes else 0
    cxl_size = ms_size + oa_size + hot_size
    cold_size = _align_pages(cold_nbytes) if cold_nbytes else 0

    cxl_off = pool.cxl.alloc(cxl_size)
    try:
        rdma_off = pool.rdma.alloc(max(cold_size, PAGE_SIZE))
    except Exception:
        # don't leak the CXL region when the cold alloc fails
        pool.cxl.free(cxl_off, cxl_size)
        raise

    regions = SnapshotRegions(
        name=name, version=version,
        cxl_off=cxl_off, cxl_size=cxl_size,
        ms_size=ms_size, oa_size=oa_size, hot_bytes=hot_nbytes,
        rdma_off=rdma_off, rdma_size=max(cold_size, PAGE_SIZE),
        cold_bytes=cold_nbytes,
        total_pages=image.total_pages,
        n_hot=int(hot.size), n_cold=int(cold.size), n_zero=classes.n_zero,
        cold_raw_bytes=cold_nbytes,
    )

    dev = pool.device
    pool.cxl.write(regions.ms_off, _to_device(np.frombuffer(bytearray(ms), np.uint8), dev))
    pool.cxl.write(regions.oa_off, _to_device(oa, dev))
    if hot_nbytes:
        pool.cxl.write(regions.hot_off, hot_mat)
    if cold_nbytes:
        pool.rdma.write(rdma_off, cold_mat)
    if checksums is not None:
        # advisory in-memory integrity record (NOT serialized — to_dict /
        # from_dict round-trips drop it)
        regions.page_checksums = checksums
    return regions


def free_snapshot(pool: HierarchicalPool, regions: SnapshotRegions) -> None:
    """Return a snapshot's storage."""
    _check_private(regions)
    pool.cxl.free(regions.cxl_off, regions.cxl_size)
    pool.rdma.free(regions.rdma_off, regions.rdma_size)


def estimate_snapshot_cxl_size(
    image: StateImage,
    working_set: Sequence[int],
    zero_bitmap: Optional[np.ndarray] = None,
    metadata: Optional[dict] = None,
    compress_cold: bool = False,
    dedup: bool = False,
) -> int:
    """CXL bytes :func:`build_snapshot` would allocate for this publish —
    machine state + offset array + hot data — WITHOUT building anything.
    It matches the build's own arithmetic exactly."""
    if dedup:
        raise NotImplementedError(_DEDUP_TODO)
    if compress_cold:
        raise NotImplementedError(_ZSTD_TODO)
    classes = classify_pages(image, working_set, zero_bitmap)
    ms = _serialize_machine_state(image.manifest, metadata or {})
    ms_size = _align_pages(len(ms))
    oa_size = _align_pages(image.total_pages * 8)
    hot_size = (_align_pages(int(classes.hot_pages.size) * PAGE_SIZE)
                if classes.hot_pages.size else 0)
    return ms_size + oa_size + hot_size


def reconstruct_image(pool: HierarchicalPool, regions: SnapshotRegions) -> StateImage:
    """Owner-side full materialization of a stored snapshot.

    Reads the tiers directly (no incoherent HostView cache in the path) and
    reassembles the exact ``StateImage`` the snapshot was built from, on the
    pool's device: hot pages from CXL, cold pages from RDMA, zero pages left
    zero.
    """
    _check_private(regions)
    ms_raw = pool.cxl.read(regions.ms_off, regions.ms_size).cpu().numpy()
    manifest, _meta = _deserialize_machine_state(ms_raw)
    oa = pool.cxl.read(regions.oa_off, regions.total_pages * 8).cpu().numpy().view(np.uint64)
    image = StateImage.empty_like(manifest, device=pool.device)
    mat = image.pages_matrix()
    nonzero = oa != ZERO_SENTINEL
    tiers = (oa >> TIER_SHIFT).astype(np.int64)
    hot = np.nonzero(nonzero & (tiers == TIER_CXL))[0]
    cold = np.nonzero(nonzero & (tiers == TIER_RDMA))[0]
    # both data regions are rank-compacted: ranks are ordered by guest page
    if hot.size:
        raw = pool.cxl.read(regions.hot_off, int(hot.size) * PAGE_SIZE)
        mat[torch.from_numpy(hot).to(mat.device)] = raw.view(int(hot.size), PAGE_SIZE)
    if cold.size:
        raw = pool.rdma.read(regions.rdma_off, int(cold.size) * PAGE_SIZE)
        mat[torch.from_numpy(cold).to(mat.device)] = raw.view(int(cold.size), PAGE_SIZE)
    return image


def plan_recuration(*_args, **_kwargs):
    """Heat-driven rebuild plan (reference ``snapshot.plan_recuration``)."""
    raise NotImplementedError(_RECURATE_TODO)


class SnapshotReader:
    """Borrower-side reader over a published snapshot (read-only!).

    CXL sections are read through the host's (incoherent) ``HostView``; the
    caller must have run the borrow protocol, which invalidates the relevant
    cache lines first (§3.3).  RDMA reads go to the tier directly (one-sided
    reads are uncached).  Returned page bytes are tensors on the pool's
    device; the offset array is read back to the host once and cached.
    """

    def __init__(self, regions: SnapshotRegions, cxl_view: HostView, rdma: MemoryTier):
        _check_private(regions)
        self.regions = regions
        self.view = cxl_view
        self.rdma = rdma
        self._oa: Optional[np.ndarray] = None
        self._manifest: Optional[Manifest] = None
        self._metadata: Optional[dict] = None
        self._hot_runs: Optional[np.ndarray] = None
        self._cold_runs: Optional[np.ndarray] = None
        self._zero_runs: Optional[np.ndarray] = None

    def page_checksums(self) -> Optional[torch.Tensor]:
        """Publish-time per-page checksum table (guest-page-indexed int32
        tensor of uint32 bits) when the snapshot was built through the fused
        publish sweep; None otherwise (restores then skip verification)."""
        return getattr(self.regions, "page_checksums", None)

    # -- resilient CXL access -------------------------------------------------
    def cxl_health(self):
        """The CXL tier's circuit breaker (None for a bare MemoryTier)."""
        return getattr(self.view.tier, "health", None)

    def degraded_cxl_read(self, off: int, nbytes: int) -> torch.Tensor:
        """Serve CXL-resident bytes while the host's CXL link is browned
        out: the pool ships the same bytes over the RDMA transport, so the
        restore completes bit-identically at the all-cold cost instead of
        failing.  The HostView line cache is bypassed."""
        data = self.view.tier.buf[off : off + nbytes].clone()
        arb = self.rdma.arbiter_for(self.view.host)
        self.view.ledger.add("rdma_read", arb.charge(nbytes))
        self.view.stats["degraded_reads"] = (
            self.view.stats.get("degraded_reads", 0) + 1)
        return data

    def cxl_read(self, off: int, nbytes: int) -> torch.Tensor:
        """A HostView read that survives link faults: transient faults are
        surfaced to the caller's retry policy, but once the breaker is OPEN
        the read degrades to :meth:`degraded_cxl_read`."""
        ht = self.cxl_health()
        if ht is not None and not ht.allow():
            return self.degraded_cxl_read(off, nbytes)
        try:
            data = self.view.read(off, nbytes)
        except TierFaultError as e:
            if ht is None:
                raise
            ht.record_failure(hard=(e.kind == "brownout"))
            if not ht.allow():
                return self.degraded_cxl_read(off, nbytes)
            raise
        if ht is not None:
            ht.record_success()
        return data

    # -- protocol hook ------------------------------------------------------
    def invalidate_cxl(self) -> None:
        """clflushopt over machine state + offset array + hot data (§3.3)."""
        r = self.regions
        self.view.invalidate(r.cxl_off, r.ms_size + r.oa_size + max(r.hot_bytes, 0))

    # -- index + machine state ----------------------------------------------
    def machine_state(self) -> Tuple[Manifest, dict]:
        if self._manifest is None:
            raw = self.cxl_read(self.regions.ms_off, self.regions.ms_size).cpu().numpy()
            self._manifest, self._metadata = _deserialize_machine_state(raw)
        return self._manifest, self._metadata

    def offset_array(self) -> np.ndarray:
        """The uint64 offset array on the host (one device→host copy)."""
        if self._oa is None:
            raw = self.cxl_read(self.regions.oa_off, self.regions.total_pages * 8)
            self._oa = raw.cpu().numpy().view(np.uint64)
        return self._oa

    # -- page lookup ----------------------------------------------------------
    def lookup(self, page: int) -> Tuple[str, int]:
        """-> ("zero", 0) | ("cxl", pool_byte_offset) | ("rdma", pool_byte_offset)."""
        slot = self.offset_array()[page]
        if slot == ZERO_SENTINEL:
            return "zero", 0
        tier, off = decode_slot(slot)
        if tier == TIER_CXL:
            return "cxl", self.regions.hot_off + off
        return "rdma", self.regions.rdma_off + off

    def read_page(self, page: int) -> torch.Tensor:
        kind, off = self.lookup(page)
        if kind == "zero":
            return torch.zeros(PAGE_SIZE, dtype=torch.uint8, device=self.rdma.device)
        if kind == "cxl":
            return self.cxl_read(off, PAGE_SIZE)
        return self.rdma.read(off, PAGE_SIZE)

    def hot_page_indices(self) -> np.ndarray:
        oa = self.offset_array()
        return np.nonzero((oa != ZERO_SENTINEL) & ((oa >> TIER_SHIFT) == TIER_CXL))[0]

    def cold_page_indices(self) -> np.ndarray:
        oa = self.offset_array()
        return np.nonzero((oa != ZERO_SENTINEL) & ((oa >> TIER_SHIFT) == TIER_RDMA))[0]

    def zero_page_indices(self) -> np.ndarray:
        return np.nonzero(self.offset_array() == ZERO_SENTINEL)[0]

    # -- run index (batched serving, §3.4) -----------------------------------
    # build_snapshot assigns tier offsets rank-by-rank over the *sorted* page
    # set, so guest-contiguous pages of one class are also contiguous in their
    # tier's data region.  A run can therefore be served by ONE tier read.

    def hot_runs(self) -> np.ndarray:
        """int64 (R, 2) [start_page, n_pages] runs of the hot set (cached)."""
        if self._hot_runs is None:
            self._hot_runs = runs_of_indices(self.hot_page_indices())
        return self._hot_runs

    def cold_runs(self) -> np.ndarray:
        """int64 (R, 2) [start_page, n_pages] runs of the cold set (cached)."""
        if self._cold_runs is None:
            self._cold_runs = runs_of_indices(self.cold_page_indices())
        return self._cold_runs

    def zero_runs(self) -> np.ndarray:
        """int64 (R, 2) [start_page, n_pages] runs of zero pages (cached)."""
        if self._zero_runs is None:
            self._zero_runs = runs_of_indices(self.zero_page_indices())
        return self._zero_runs

    def iter_cold_extents(self, max_extent_pages: int = 64,
                          largest_first: bool = True):
        """Yield ``(es, en, rank0, pool_off, nbytes)`` extents covering the
        cold runs (largest-first by default), each readable with ONE
        one-sided read.  The prefetcher and the node-level pump consume this
        one splitting arithmetic, so they cannot drift apart."""
        runs = self.cold_runs()
        if runs.size == 0:
            return
        order = (np.argsort(-runs[:, 1], kind="stable") if largest_first
                 else range(runs.shape[0]))
        for ri in order:
            start, n = int(runs[ri, 0]), int(runs[ri, 1])
            for es in range(start, start + n, max_extent_pages):
                en = min(max_extent_pages, start + n - es)
                rank0 = self.cold_rank(es)
                pool_off, nbytes = self.cold_extent_span(rank0, en)
                yield es, en, rank0, pool_off, nbytes

    def iter_hot_extents(self, chunk_pages: int = 256):
        """Yield ``(pages, pool_off, nbytes)`` CXL extents covering the hot
        set, each readable with ONE sequential CXL read of ``nbytes`` at
        ``pool_off`` whose i-th page belongs to guest page ``pages[i]``.  The
        hot region is rank-compacted, so this is the region streamed in
        ``chunk_pages`` chunks (``pages`` ascending)."""
        hot = self.hot_page_indices()
        hot_off = self.regions.hot_off
        for r0 in range(0, int(hot.size), chunk_pages):
            r1 = min(int(hot.size), r0 + chunk_pages)
            yield (hot[r0:r1], hot_off + r0 * PAGE_SIZE,
                   (r1 - r0) * PAGE_SIZE)

    def cold_rank(self, page: int) -> int:
        """Rank (position in the sorted cold set) of a cold page."""
        _tier, off = decode_slot(self.offset_array()[page])
        return off // PAGE_SIZE

    def cold_extent_span(self, rank: int, n: int) -> Tuple[int, int]:
        """Byte span of `n` consecutive cold ranks in the RDMA tier:
        ``(pool_byte_offset, nbytes)``."""
        return self.regions.rdma_off + rank * PAGE_SIZE, n * PAGE_SIZE

    def split_cold_extent(self, rank: int, n: int, payload: torch.Tensor) -> torch.Tensor:
        """One cold extent's payload as an (n, PAGE_SIZE) matrix (a view)."""
        return payload[: n * PAGE_SIZE].view(n, PAGE_SIZE)
