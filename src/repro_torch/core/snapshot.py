"""Hotness-based snapshot format (§3.2): private and content-addressed layouts.

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

The content-addressed (dedup) layout routes page payloads through the pool's
per-tier ``DedupStore``s instead: offset-array slots hold refcounted
ABSOLUTE tier offsets, the private CXL region holds only machine state and
offset array, and there is no private RDMA region.

Page bytes stay on the pool's device; the offset array, page classes and run
index are host numpy (read back from the device once).

The private layout's cold tier can be stored zstd-compressed per page
(``compress_cold``): cold slots then hold the page's RANK and a uint32
length index (high bit: stored raw) follows the offset array in CXL:
    [ machine_state | offset_array | cold_length_index | hot page data ]
Compression and decompression run on the host, on the payload's bytes; the
decompressed pages go back to the pool's device and install like any other
cold page.  Without the ``zstandard`` package a ``compress_cold`` publish
stores the cold tier uncompressed (``cold_compressed=False``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

try:
    import zstandard as _zstd
except Exception:  # optional: without it compress_cold publishes uncompressed
    _zstd = None

from ..kernels.page_gather import page_gather
from ..kernels.page_scatter import page_scatter
from . import trace
from .faults import TierFaultError
from .pagestore import PAGE_SIZE, Manifest, StateImage, num_pages
from .pool import TIER_CXL, TIER_RDMA, HierarchicalPool, HostView, MemoryTier

ZERO_SENTINEL = np.uint64(0xFFFF_FFFF_FFFF_FFFF)
TIER_SHIFT = np.uint64(62)
OFFSET_MASK = np.uint64((1 << 62) - 1)

RAW_BIT = np.uint32(0x8000_0000)      # cold-length index: page stored raw
LEN_MASK = np.uint32(0x7FFF_FFFF)


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


def _offset_subruns(offsets: np.ndarray):
    """Yield ``(start_index, length)`` over positions of ``offsets`` such
    that each run's byte offsets are PAGE_SIZE-adjacent — the dedup
    extent-splitting primitive."""
    n = int(offsets.size)
    if n == 0:
        return
    brk = np.nonzero(np.diff(offsets) != PAGE_SIZE)[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk + 1, [n]])
    for a, b in zip(starts.tolist(), ends.tolist()):
        yield a, b - a


def _offset_runs(sorted_offsets: np.ndarray):
    """Yield ``(byte_offset, n_pages)`` maximal adjacent runs of SORTED
    absolute page offsets (dedup flush/read coalescing)."""
    for a, k in _offset_subruns(sorted_offsets):
        yield int(sorted_offsets[a]), k


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
    # zstd-compressed cold tier: cold offset-array slots hold the page RANK
    # (not a byte offset) and a uint32 per-cold-page length table lives in
    # CXL after the offset array (ci_size bytes, page-aligned)
    cold_compressed: bool = False
    ci_size: int = 0
    cold_raw_bytes: int = 0       # uncompressed cold payload (for ratio)
    # content-addressed layout (core/dedup.py): page payloads live in the
    # per-tier DedupStores and offset-array slots hold ABSOLUTE tier byte
    # offsets (refcounted, possibly shared across snapshots); no private
    # RDMA region (rdma_size == 0).  Mutually exclusive with cold_compressed.
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


def _serialize_machine_state(manifest: Manifest, metadata: dict) -> bytes:
    blob = json.dumps({"manifest": manifest.to_dict(), "metadata": metadata}).encode()
    return len(blob).to_bytes(8, "little") + blob


def _deserialize_machine_state(raw: np.ndarray) -> Tuple[Manifest, dict]:
    n = int.from_bytes(raw[:8].tobytes(), "little")
    d = json.loads(raw[8 : 8 + n].tobytes().decode())
    return Manifest.from_dict(d["manifest"]), d["metadata"]


def _compress_cold(cold_mat: torch.Tensor) -> Tuple[bytes, np.ndarray]:
    """Per-page zstd on the host: ``(blob, lengths uint32)``.  Pages that do
    not shrink are stored raw with :data:`RAW_BIT` set in their length."""
    cctx = _zstd.ZstdCompressor(level=3)
    rows = cold_mat.reshape(-1, PAGE_SIZE).cpu().numpy()
    chunks = []
    lengths = np.zeros(rows.shape[0], dtype=np.uint32)
    for i in range(rows.shape[0]):
        raw = rows[i].tobytes()
        z = cctx.compress(raw)
        if len(z) < PAGE_SIZE:
            chunks.append(z)
            lengths[i] = len(z)
        else:
            chunks.append(raw)
            lengths[i] = RAW_BIT | PAGE_SIZE
    return b"".join(chunks), lengths


def _decompress(dctx, payload: np.ndarray, is_raw: bool) -> np.ndarray:
    """One stored cold page (host bytes) back to its 4 KiB."""
    if is_raw:
        return payload[:PAGE_SIZE]
    out = dctx.decompress(payload.tobytes(), max_output_size=PAGE_SIZE)
    return np.frombuffer(out, dtype=np.uint8)


def _cold_starts(ci: np.ndarray) -> np.ndarray:
    """Byte start of each rank's payload in the compressed cold region."""
    lens = (ci & LEN_MASK).astype(np.int64)
    return np.concatenate([[0], np.cumsum(lens)[:-1]])


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
    gather (default: the ``page_gather`` kernel).  ``publish_fn(pages_matrix,
    ws_bool) -> FusedPublishResult`` goes further: the fused single-sweep kernel
    replaces the zero scan, the checksum AND both gathers in one pass; its
    per-page checksum column is recorded on the returned regions (in-memory
    ``page_checksums`` attribute, guest-page-indexed int32 tensor on the
    device) so restores can verify installed pages against publish-time
    content.  When set it supersedes ``zero_bitmap``/``gather_fn``.
    ``compress_cold`` stores the RDMA tier zstd-compressed per page (on the
    host; uncompressed when ``zstandard`` is not installed).
    ``dedup`` routes page payloads through the pool's content-addressed
    stores instead of private data regions (offset-array slots then hold
    refcounted absolute tier offsets); it disables ``compress_cold``.
    """
    if dedup:
        return _build_snapshot_dedup(pool, image, working_set, name,
                                     version=version, metadata=metadata,
                                     zero_bitmap=zero_bitmap,
                                     gather_fn=gather_fn,
                                     publish_fn=publish_fn)
    compress_cold = compress_cold and _zstd is not None
    checksums = None
    if publish_fn is not None:
        classes, hot_mat, cold_mat, checksums = _run_publish_fn(
            publish_fn, image, working_set)
    else:
        classes = classify_pages(image, working_set, zero_bitmap)
        gather = gather_fn or page_gather
        mat = image.pages_matrix()
        hot_mat = gather(mat, classes.hot_pages) if classes.hot_pages.size else None
        cold_mat = gather(mat, classes.cold_pages) if classes.cold_pages.size else None
    hot, cold = classes.hot_pages, classes.cold_pages
    hot_nbytes = int(hot.size) * PAGE_SIZE
    cold_raw_bytes = int(cold.size) * PAGE_SIZE

    ci = np.zeros(0, dtype=np.uint32)
    if compress_cold and cold.size:
        blob, ci = _compress_cold(cold_mat)
        cold_data = torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(pool.device)
    else:
        compress_cold = False
        cold_data = cold_mat
    cold_nbytes = len(blob) if compress_cold else cold_raw_bytes

    # Offset array: slot per guest page (byte offset within the tier region,
    # or the rank when the cold tier is compressed).
    oa = np.full(image.total_pages, ZERO_SENTINEL, dtype=np.uint64)
    if hot.size:
        oa[hot] = (np.uint64(TIER_CXL) << TIER_SHIFT) | (
            np.arange(hot.size, dtype=np.uint64) * np.uint64(PAGE_SIZE)
        )
    if cold.size:
        stride = np.uint64(1) if compress_cold else np.uint64(PAGE_SIZE)
        oa[cold] = (np.uint64(TIER_RDMA) << TIER_SHIFT) | (
            np.arange(cold.size, dtype=np.uint64) * stride
        )

    ms = _serialize_machine_state(image.manifest, metadata or {})
    ms_size = _align_pages(len(ms))
    oa_size = _align_pages(oa.nbytes)
    ci_size = _align_pages(ci.nbytes) if compress_cold else 0
    hot_size = _align_pages(hot_nbytes) if hot_nbytes else 0
    cxl_size = ms_size + oa_size + ci_size + hot_size
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
        cold_compressed=compress_cold, ci_size=ci_size,
        cold_raw_bytes=cold_raw_bytes,
    )

    dev = pool.device
    pool.cxl.write(regions.ms_off, _to_device(np.frombuffer(bytearray(ms), np.uint8), dev))
    pool.cxl.write(regions.oa_off, _to_device(oa, dev))
    if compress_cold:
        pool.cxl.write(regions.ci_off, _to_device(ci, dev))
    if hot_nbytes:
        pool.cxl.write(regions.hot_off, hot_mat)
    if cold_nbytes:
        pool.rdma.write(rdma_off, cold_data)
    if checksums is not None:
        # advisory in-memory integrity record (NOT serialized — to_dict /
        # from_dict round-trips drop it)
        regions.page_checksums = checksums
    return regions


def _build_snapshot_dedup(
    pool: HierarchicalPool,
    image: StateImage,
    working_set: Sequence[int],
    name: str,
    version: int = 0,
    metadata: Optional[dict] = None,
    zero_bitmap: Optional[np.ndarray] = None,
    gather_fn=None,
    publish_fn=None,
) -> SnapshotRegions:
    """Content-addressed build: page payloads go through the per-tier
    DedupStores (one refcount per offset-array slot); only machine state and
    the offset array occupy a private, contiguous CXL region.  A mid-build
    ``AllocError`` rolls every reference taken by this build back, so a
    failed publish leaves both stores and the tiers unchanged.

    With ``publish_fn`` the fused sweep's checksum column feeds the stores:
    when a store hashes with the polynomial checksum (``is_poly32``),
    ``put_pages`` receives the precomputed hashes and launches no hash of
    its own."""
    checksums = None
    if publish_fn is not None:
        classes, hot_mat, cold_mat, checksums = _run_publish_fn(
            publish_fn, image, working_set)
    else:
        classes = classify_pages(image, working_set, zero_bitmap)
        gather = gather_fn or page_gather
        mat = image.pages_matrix()
        empty = torch.zeros((0, PAGE_SIZE), dtype=torch.uint8, device=image.device)
        hot_mat = gather(mat, classes.hot_pages) if classes.hot_pages.size else empty
        cold_mat = gather(mat, classes.cold_pages) if classes.cold_pages.size else empty
    hot, cold = classes.hot_pages, classes.cold_pages

    ms = _serialize_machine_state(image.manifest, metadata or {})
    ms_size = _align_pages(len(ms))
    oa_size = _align_pages(image.total_pages * 8)
    cxl_size = ms_size + oa_size

    def _hashes_for(store, idx):
        """Fused checksums reused as the store's hash input — only when the
        store itself hashes with the same 32-bit polynomial checksum."""
        if checksums is None or not getattr(store.hash_fn, "is_poly32", False):
            return None
        return checksums[torch.from_numpy(idx).to(checksums.device)]

    cxl_off = pool.cxl.alloc(cxl_size)
    hot_offs = np.zeros(0, dtype=np.int64)
    try:
        hot_offs = pool.dedup_cxl.put_pages(
            hot_mat, hashes=_hashes_for(pool.dedup_cxl, hot))
        cold_offs = pool.dedup_rdma.put_pages(
            cold_mat, hashes=_hashes_for(pool.dedup_rdma, cold))
    except Exception:
        if hot_offs.size:
            pool.dedup_cxl.release_offsets(hot_offs)
        pool.cxl.free(cxl_off, cxl_size)
        raise

    oa = np.full(image.total_pages, ZERO_SENTINEL, dtype=np.uint64)
    if hot.size:
        oa[hot] = (np.uint64(TIER_CXL) << TIER_SHIFT) | hot_offs.astype(np.uint64)
    if cold.size:
        oa[cold] = (np.uint64(TIER_RDMA) << TIER_SHIFT) | cold_offs.astype(np.uint64)

    regions = SnapshotRegions(
        name=name, version=version,
        cxl_off=cxl_off, cxl_size=cxl_size,
        ms_size=ms_size, oa_size=oa_size,
        hot_bytes=int(hot.size) * PAGE_SIZE,
        rdma_off=0, rdma_size=0,
        cold_bytes=int(cold.size) * PAGE_SIZE,
        total_pages=image.total_pages,
        n_hot=int(hot.size), n_cold=int(cold.size), n_zero=classes.n_zero,
        cold_raw_bytes=int(cold.size) * PAGE_SIZE,
        dedup=True,
    )
    dev = pool.device
    pool.cxl.write(regions.ms_off, _to_device(np.frombuffer(bytearray(ms), np.uint8), dev))
    pool.cxl.write(regions.oa_off, _to_device(oa, dev))
    if checksums is not None:
        regions.page_checksums = checksums
    return regions


def decode_dedup_offsets(pool: HierarchicalPool, regions: SnapshotRegions,
                         tier_tag: int) -> np.ndarray:
    """Absolute store offsets a dedup snapshot's offset array holds for one
    tier (owner-side direct read of the stored offset array)."""
    oa = pool.cxl.read(regions.oa_off, regions.total_pages * 8).cpu().numpy().view(np.uint64)
    sel = (oa != ZERO_SENTINEL) & ((oa >> TIER_SHIFT) == np.uint64(tier_tag))
    return (oa[sel] & OFFSET_MASK).astype(np.int64)


def free_snapshot(pool: HierarchicalPool, regions: SnapshotRegions) -> None:
    """Return a snapshot's storage.  For dedup snapshots this DECREMENTS the
    per-page references (one per offset-array slot); the stores free tier
    bytes only for pages whose last reference this was."""
    if regions.dedup:
        # read the offset array BEFORE freeing the metadata region that
        # holds it — it is the authoritative list of held references
        pool.dedup_cxl.release_offsets(decode_dedup_offsets(pool, regions, TIER_CXL))
        pool.dedup_rdma.release_offsets(decode_dedup_offsets(pool, regions, TIER_RDMA))
        pool.cxl.free(regions.cxl_off, regions.cxl_size)
        return
    pool.cxl.free(regions.cxl_off, regions.cxl_size)
    pool.rdma.free(regions.rdma_off, regions.rdma_size)


def exclusive_cxl_bytes(pool: HierarchicalPool, regions: SnapshotRegions) -> int:
    """CXL bytes demoting/deleting this snapshot's hot set would actually
    reclaim.  For a private layout that is the whole hot section; for a
    dedup layout only pages whose store refcount equals THIS snapshot's own
    reference count free on release."""
    if not regions.dedup:
        return regions.cxl_size - regions.ms_size - regions.oa_size - regions.ci_size
    offs = decode_dedup_offsets(pool, regions, TIER_CXL)
    if offs.size == 0:
        return 0
    refs = pool.dedup_cxl.refcounts()
    uniq, counts = np.unique(offs, return_counts=True)
    exclusive = sum(1 for off, mine in zip(uniq.tolist(), counts.tolist())
                    if refs.get(off, 0) == mine)
    return exclusive * PAGE_SIZE


def estimate_snapshot_cxl_size(
    image: StateImage,
    working_set: Sequence[int],
    zero_bitmap: Optional[np.ndarray] = None,
    metadata: Optional[dict] = None,
    compress_cold: bool = False,
    dedup: bool = False,
    pool: Optional[HierarchicalPool] = None,
) -> int:
    """CXL bytes :func:`build_snapshot` would allocate for this publish —
    machine state + offset array + cold-length index (compressed cold
    tier) + hot data — WITHOUT building anything.  It matches the build's
    own arithmetic exactly.

    With ``dedup`` (requires ``pool``) the hot-data term is the MARGINAL
    size: only page contents the CXL store does not already hold count."""
    compress_cold = compress_cold and _zstd is not None and not dedup
    classes = classify_pages(image, working_set, zero_bitmap)
    ms = _serialize_machine_state(image.manifest, metadata or {})
    ms_size = _align_pages(len(ms))
    oa_size = _align_pages(image.total_pages * 8)
    if dedup:
        assert pool is not None, "dedup estimate needs the pool's stores"
        hot = classes.hot_pages
        hot_new = (pool.dedup_cxl.probe_new_bytes(page_gather(image.pages_matrix(), hot))
                   if hot.size else 0)
        return ms_size + oa_size + hot_new
    ci_size = (_align_pages(int(classes.cold_pages.size) * 4)
               if compress_cold and classes.cold_pages.size else 0)
    hot_size = (_align_pages(int(classes.hot_pages.size) * PAGE_SIZE)
                if classes.hot_pages.size else 0)
    return ms_size + oa_size + ci_size + hot_size


def reconstruct_image(pool: HierarchicalPool, regions: SnapshotRegions) -> StateImage:
    """Owner-side full materialization of a stored snapshot.

    Reads the tiers directly (no incoherent HostView cache in the path) and
    reassembles the exact ``StateImage`` the snapshot was built from, on the
    pool's device: hot pages from CXL, cold pages from RDMA, zero pages left
    zero.  For a dedup snapshot each tier's pages are collected by one
    ``page_gather`` of the tier's page rows and installed by one
    ``page_scatter`` into the image.  A compressed cold tier is read page by
    page, as the reference reads it, and decompressed on the host.
    """
    ms_raw = pool.cxl.read(regions.ms_off, regions.ms_size).cpu().numpy()
    manifest, _meta = _deserialize_machine_state(ms_raw)
    oa = pool.cxl.read(regions.oa_off, regions.total_pages * 8).cpu().numpy().view(np.uint64)
    image = StateImage.empty_like(manifest, device=pool.device)
    mat = image.pages_matrix()
    nonzero = oa != ZERO_SENTINEL
    tiers = (oa >> TIER_SHIFT).astype(np.int64)
    hot = np.nonzero(nonzero & (tiers == TIER_CXL))[0]
    cold = np.nonzero(nonzero & (tiers == TIER_RDMA))[0]
    if regions.dedup:
        offs = (oa & OFFSET_MASK).astype(np.int64)
        for pages_sel, tier in ((hot, pool.cxl), (cold, pool.rdma)):
            if pages_sel.size:
                _gather_store_pages(tier, mat, pages_sel, offs[pages_sel])
        return image
    # both data regions are rank-compacted: ranks are ordered by guest page
    if hot.size:
        raw = pool.cxl.read(regions.hot_off, int(hot.size) * PAGE_SIZE)
        mat[torch.from_numpy(hot).to(mat.device)] = raw.view(int(hot.size), PAGE_SIZE)
    if cold.size and regions.cold_compressed:
        ci = pool.cxl.read(regions.ci_off, regions.n_cold * 4).cpu().numpy().view(np.uint32)
        starts = _cold_starts(ci)
        dctx = _zstd.ZstdDecompressor()
        rows = np.empty((int(cold.size), PAGE_SIZE), dtype=np.uint8)
        ranks = (oa[cold] & OFFSET_MASK).astype(np.int64)
        for i, rank in enumerate(ranks.tolist()):
            payload = pool.rdma.read(regions.rdma_off + int(starts[rank]),
                                     int(ci[rank] & LEN_MASK)).cpu().numpy()
            rows[i] = _decompress(dctx, payload, bool(ci[rank] & RAW_BIT))
        mat[torch.from_numpy(cold).to(mat.device)] = torch.from_numpy(rows).to(mat.device)
    elif cold.size:
        raw = pool.rdma.read(regions.rdma_off, int(cold.size) * PAGE_SIZE)
        mat[torch.from_numpy(cold).to(mat.device)] = raw.view(int(cold.size), PAGE_SIZE)
    return image


def _gather_store_pages(tier: MemoryTier, mat: torch.Tensor, pages: np.ndarray,
                        offs: np.ndarray) -> None:
    """``mat[pages[i]] = tier page at offs[i]``.  The reference reads each run
    of adjacent store offsets with one owner-side ``tier.read``; with a
    fault injector armed, the same reads are checked and the same poison is
    applied to the gathered rows, run by run, before they are installed."""
    order = np.argsort(offs, kind="stable")
    pages_o, offs_o = pages[order], offs[order]
    rows = page_gather(tier.page_rows(), offs_o // PAGE_SIZE)
    fi = tier.fault_injector
    if fi is not None:
        for a, k in _offset_subruns(offs_o):
            off, nbytes = int(offs_o[a]), k * PAGE_SIZE
            fi.check_read(tier.name, off, nbytes)
            fi.filter_read(tier.name, off, nbytes, rows[a : a + k].view(-1))
    page_scatter(mat, rows, pages_o)


# --------------------------------------------------------------------------
# Online re-curation (heat-feedback snapshot rebuild)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RecurationPlan:
    """What a heat-driven rebuild of one snapshot would change.

    ``promote`` — currently-cold pages whose decayed heat says they belong
    in the CXL hot region; ``demote`` — currently-hot pages never touched
    across enough restores; ``new_working_set`` — the hot set the rebuilt
    snapshot will pre-install.
    """

    name: str
    version: int
    promote: np.ndarray
    demote: np.ndarray
    new_working_set: np.ndarray
    n_hot_before: int
    n_hot_after: int
    # promote set ordered by the predicted-first-touch model
    model_ordered: bool = False

    @property
    def changed(self) -> bool:
        return bool(self.promote.size or self.demote.size)

    def summary(self) -> Dict[str, int]:
        return {
            "promote": int(self.promote.size),
            "demote": int(self.demote.size),
            "hot_before": self.n_hot_before,
            "hot_after": self.n_hot_after,
            "model_ordered": int(self.model_ordered),
        }


def plan_recuration(
    pool: HierarchicalPool,
    regions: SnapshotRegions,
    heat,
    min_promote_heat: float = 1.0,
    demote_max_heat: float = 1e-3,
    min_restores: int = 2,
    model=None,
    max_promote: Optional[int] = None,
) -> RecurationPlan:
    """Derive promote/demote sets for one snapshot from its heat map.

    Owner-side: the offset array is read straight from the CXL tier (the
    owner wrote it; no HostView cache in the path), one device→host copy.
    ``heat`` is the snapshot's :class:`~repro_torch.core.profiler.HeatMap`.

    ``model`` (a :class:`~repro_torch.core.prefetch_model.PrefetchModel`,
    usually fitted from the same heat map) re-ranks the promote set by
    predicted first-touch order, so under a ``max_promote`` budget the
    earliest-touched drifted pages make the cut.
    """
    oa = pool.cxl.read(regions.oa_off, regions.total_pages * 8).cpu().numpy().view(np.uint64)
    nonzero = oa != ZERO_SENTINEL
    tiers = oa >> TIER_SHIFT
    hot = np.nonzero(nonzero & (tiers == np.uint64(TIER_CXL)))[0].astype(np.int64)
    cold = np.nonzero(nonzero & (tiers == np.uint64(TIER_RDMA)))[0].astype(np.int64)
    promote = heat.promotion_candidates(cold, min_heat=min_promote_heat)
    model_ordered = False
    if model is not None and promote.size:
        promote = model.page_order(promote)
        model_ordered = True
    if max_promote is not None:
        promote = promote[:int(max_promote)]
    demote = heat.demotion_candidates(hot, max_heat=demote_max_heat,
                                      min_restores=min_restores)
    keep = hot[~np.isin(hot, demote)] if demote.size else hot
    new_ws = np.union1d(keep, promote).astype(np.int64)
    return RecurationPlan(
        name=regions.name, version=regions.version,
        promote=promote, demote=demote, new_working_set=new_ws,
        n_hot_before=int(hot.size), n_hot_after=int(new_ws.size),
        model_ordered=model_ordered,
    )


class SnapshotReader:
    """Borrower-side reader over a published snapshot (read-only!).

    CXL sections are read through the host's (incoherent) ``HostView``; the
    caller must have run the borrow protocol, which invalidates the relevant
    cache lines first (§3.3).  RDMA reads go to the tier directly (one-sided
    reads are uncached).  Returned page bytes are tensors on the pool's
    device; the offset array is read back to the host once and cached.
    """

    def __init__(self, regions: SnapshotRegions, cxl_view: HostView, rdma: MemoryTier):
        self.regions = regions
        self.view = cxl_view
        self.rdma = rdma
        self._oa: Optional[np.ndarray] = None
        self._manifest: Optional[Manifest] = None
        self._metadata: Optional[dict] = None
        self._ci: Optional[np.ndarray] = None       # cold lengths (compressed tier)
        self._ci_starts: Optional[np.ndarray] = None
        self._dctx = _zstd.ZstdDecompressor() if _zstd is not None else None
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
        """clflushopt over machine state + offset array + hot data (§3.3).

        A dedup snapshot has no contiguous hot section: the metadata region
        is flushed first, then the (now-fresh) offset array is decoded and
        each maximal run of ADJACENT store offsets flushed separately."""
        r = self.regions
        if not r.dedup:
            self.view.invalidate(r.cxl_off, r.ms_size + r.oa_size + max(r.hot_bytes, 0))
            return
        self.view.invalidate(r.cxl_off, r.ms_size + r.oa_size)
        oa = self.offset_array()
        sel = (oa != ZERO_SENTINEL) & ((oa >> TIER_SHIFT) == np.uint64(TIER_CXL))
        offs = np.sort((oa[sel] & OFFSET_MASK).astype(np.int64))
        for off, n in _offset_runs(offs):
            self.view.invalidate(int(off), int(n) * PAGE_SIZE)

    # -- index + machine state ----------------------------------------------
    def machine_state(self) -> Tuple[Manifest, dict]:
        if self._manifest is None:
            raw = self.cxl_read(self.regions.ms_off, self.regions.ms_size).cpu().numpy()
            trace.count("device.syncs")
            self._manifest, self._metadata = _deserialize_machine_state(raw)
        return self._manifest, self._metadata

    def offset_array(self) -> np.ndarray:
        """The uint64 offset array on the host (one device→host copy)."""
        if self._oa is None:
            raw = self.cxl_read(self.regions.oa_off, self.regions.total_pages * 8)
            self._oa = raw.cpu().numpy().view(np.uint64)
            trace.count("device.syncs")
        return self._oa

    def cold_index(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(starts, lengths)`` of the compressed cold tier (cached): each
        rank's byte start in the cold region and its uint32 length word
        (:data:`RAW_BIT` set for a page stored raw)."""
        if self._ci is None:
            raw = self.cxl_read(self.regions.ci_off, self.regions.n_cold * 4)
            self._ci = raw.cpu().numpy().view(np.uint32)
            trace.count("device.syncs")
            self._ci_starts = _cold_starts(self._ci)
        return self._ci_starts, self._ci

    # -- page lookup ----------------------------------------------------------
    def lookup(self, page: int) -> Tuple[str, int]:
        """-> ("zero", 0) | ("cxl", pool_byte_offset) | ("rdma", pool_byte_offset)
        | ("rdma_z", cold_rank) when the cold tier is compressed.  Dedup
        slots already hold absolute tier offsets (no region base)."""
        slot = self.offset_array()[page]
        if slot == ZERO_SENTINEL:
            return "zero", 0
        tier, off = decode_slot(slot)
        if self.regions.dedup:
            return ("cxl" if tier == TIER_CXL else "rdma"), off
        if tier == TIER_CXL:
            return "cxl", self.regions.hot_off + off
        if self.regions.cold_compressed:
            return "rdma_z", off          # off == cold rank
        return "rdma", self.regions.rdma_off + off

    def cold_extent(self, rank: int) -> Tuple[int, int, bool]:
        """-> (pool_byte_offset, length, is_raw) of one compressed cold page."""
        starts, lens = self.cold_index()
        raw = bool(lens[rank] & RAW_BIT)
        n = int(lens[rank] & LEN_MASK)
        return self.regions.rdma_off + int(starts[rank]), n, raw

    def decompress_page(self, payload: torch.Tensor, is_raw: bool) -> torch.Tensor:
        """One stored cold page back to its 4 KiB, on the payload's device
        (decompressed on the host)."""
        if is_raw:
            return payload[:PAGE_SIZE]
        out = _decompress(self._dctx, payload.cpu().numpy(), False)
        trace.count("device.syncs")
        return torch.from_numpy(out.copy()).to(payload.device)

    def read_page(self, page: int) -> torch.Tensor:
        kind, off = self.lookup(page)
        if kind == "zero":
            return torch.zeros(PAGE_SIZE, dtype=torch.uint8, device=self.rdma.device)
        if kind == "cxl":
            return self.cxl_read(off, PAGE_SIZE)
        if kind == "rdma_z":
            pool_off, n, raw = self.cold_extent(off)
            return self.decompress_page(self.rdma.read(pool_off, n), raw)
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
    # tier's data region (byte offsets for raw tiers, ranks for the compressed
    # cold tier).  A run can therefore be served by ONE tier read.

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
        one splitting arithmetic, so they cannot drift apart.

        Dedup snapshots additionally split each guest run wherever the
        stored tier offsets stop being adjacent, so every extent is
        contiguous in BOTH the guest address space and the tier."""
        runs = self.cold_runs()
        if runs.size == 0:
            return
        dedup = self.regions.dedup
        oa = self.offset_array() if dedup else None
        order = (np.argsort(-runs[:, 1], kind="stable") if largest_first
                 else range(runs.shape[0]))
        for ri in order:
            start, n = int(runs[ri, 0]), int(runs[ri, 1])
            for es in range(start, start + n, max_extent_pages):
                en = min(max_extent_pages, start + n - es)
                if not dedup:
                    rank0 = self.cold_rank(es)
                    pool_off, nbytes = self.cold_extent_span(rank0, en)
                    yield es, en, rank0, pool_off, nbytes
                    continue
                offs = (oa[es : es + en] & OFFSET_MASK).astype(np.int64)
                for a, k in _offset_subruns(offs):
                    yield (es + a, k, int(offs[a]) // PAGE_SIZE,
                           int(offs[a]), k * PAGE_SIZE)

    def iter_hot_extents(self, chunk_pages: int = 256):
        """Yield ``(pages, pool_off, nbytes)`` CXL extents covering the hot
        set, each readable with ONE sequential CXL read of ``nbytes`` at
        ``pool_off`` whose i-th page belongs to guest page ``pages[i]``.

        Private layout: the hot region is rank-compacted, so this is the
        region streamed in ``chunk_pages`` chunks (``pages`` ascending).
        Dedup layout: hot pages are visited in STORE-OFFSET order and split
        wherever offsets stop being adjacent and at absolute tier-grid
        boundaries of ``chunk_pages`` pages (so snapshots sharing store runs
        emit identical chunks); ``pages`` is then generally unsorted.  The
        sort and split are done before the first extent is yielded, inside
        the span ``serving.hot_order``."""
        hot = self.hot_page_indices()
        if hot.size == 0:
            return
        if not self.regions.dedup:
            hot_off = self.regions.hot_off
            for r0 in range(0, int(hot.size), chunk_pages):
                r1 = min(int(hot.size), r0 + chunk_pages)
                yield (hot[r0:r1], hot_off + r0 * PAGE_SIZE,
                       (r1 - r0) * PAGE_SIZE)
            return
        with trace.span("serving.hot_order"):
            offs = (self.offset_array()[hot] & OFFSET_MASK).astype(np.int64)
            order = np.argsort(offs, kind="stable")
            hot_o, offs_o = hot[order], offs[order]
            # an extent starts where store offsets stop being adjacent, and at
            # every page that starts a chunk of the absolute tier grid
            cut = np.diff(offs_o) != PAGE_SIZE
            cut |= offs_o[1:] % (chunk_pages * PAGE_SIZE) == 0
            starts = np.concatenate(([0], np.flatnonzero(cut) + 1)).tolist()
            ends = starts[1:] + [int(hot.size)]
        for s, e in zip(starts, ends):
            yield hot_o[s:e], int(offs_o[s]), (e - s) * PAGE_SIZE

    def walk_rows(self, tier: str) -> Tuple[np.ndarray, np.ndarray]:
        """``(pages, pool_offs)``: every guest page of one tier's restore walk
        ("cxl": the hot set, "rdma": the cold set) and the pool byte offset
        its 4 KiB are read from — the rows :meth:`iter_hot_extents` and
        :meth:`iter_cold_extents` cover (in guest order here), without
        reading any of them.  For a compressed cold tier the offset is where
        the page's stored bytes start: no arena row holds the page itself."""
        pages = self.hot_page_indices() if tier == "cxl" else self.cold_page_indices()
        offs = (self.offset_array()[pages] & OFFSET_MASK).astype(np.int64)
        if tier == "rdma" and self.regions.cold_compressed:
            return pages, self.regions.rdma_off + self.cold_index()[0][offs]
        if not self.regions.dedup:
            offs += self.regions.hot_off if tier == "cxl" else self.regions.rdma_off
        return pages, offs

    def cold_walk_extents(self, pages: np.ndarray, offs: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The cold walk's extents as arrays, from :meth:`walk_rows` of a raw
        cold tier: ``(pages, offs, bounds)`` reordered so that extent ``k``
        is ``pages[bounds[k]:bounds[k + 1]]`` (guest-ascending, at pool
        ``offs`` of the same slice), in the order
        ``iter_cold_extents(max_extent_pages=1 << 30,
        largest_first=regions.dedup)`` yields them: guest order for the
        private layout; for the dedup layout the guest runs largest first,
        each split where store offsets stop being adjacent (the reorder in
        the span ``serving.cold_order``)."""
        n = int(pages.size)
        run_brk = np.diff(pages) != 1
        starts = np.concatenate(
            ([0], np.flatnonzero(run_brk | (np.diff(offs) != PAGE_SIZE)) + 1)).astype(np.int64)
        if n == 0 or not self.regions.dedup:
            return pages, offs, np.append(starts[:n], n)
        with trace.span("serving.cold_order"):
            run_starts = np.concatenate(([0], np.flatnonzero(run_brk) + 1))
            run_rank = np.empty(run_starts.size, dtype=np.int64)
            run_rank[np.argsort(-np.diff(np.append(run_starts, n)), kind="stable")] = \
                np.arange(run_starts.size)
            order = np.argsort(run_rank[np.searchsorted(run_starts, starts, side="right") - 1],
                               kind="stable")
            lens = np.diff(np.append(starts, n))[order]
            bounds = np.concatenate(([0], np.cumsum(lens)))
            take = np.repeat(starts[order] - bounds[:-1], lens) + np.arange(n)
            return pages[take], offs[take], bounds

    def cold_rank(self, page: int) -> int:
        """Rank (position in the sorted cold set) of a cold page.  For a
        dedup snapshot the "rank" is the absolute tier page number."""
        _tier, off = decode_slot(self.offset_array()[page])
        return off if self.regions.cold_compressed else off // PAGE_SIZE

    def cold_extent_span(self, rank: int, n: int) -> Tuple[int, int]:
        """Byte span of `n` consecutive cold ranks in the RDMA tier:
        ``(pool_byte_offset, nbytes)``.  The compressed tier stores the ranks'
        payloads back to back, so consecutive ranks are one extent too.
        Dedup ranks are absolute tier page numbers, so no region base is
        added."""
        if self.regions.dedup:
            return rank * PAGE_SIZE, n * PAGE_SIZE
        if not self.regions.cold_compressed:
            return self.regions.rdma_off + rank * PAGE_SIZE, n * PAGE_SIZE
        starts, lens = self.cold_index()
        lo = int(starts[rank])
        hi = int(starts[rank + n - 1]) + int(lens[rank + n - 1] & LEN_MASK)
        return self.regions.rdma_off + lo, hi - lo

    def split_cold_extent(self, rank: int, n: int, payload: torch.Tensor) -> torch.Tensor:
        """One cold extent's payload as an (n, PAGE_SIZE) matrix: a view, or
        for the compressed tier the pages decompressed on the host and
        copied back to the payload's device in one transfer."""
        if not self.regions.cold_compressed:
            return payload[: n * PAGE_SIZE].view(n, PAGE_SIZE)
        starts, lens = self.cold_index()
        host = payload.cpu().numpy()
        trace.count("device.syncs")
        base = int(starts[rank])
        out = np.empty((n, PAGE_SIZE), dtype=np.uint8)
        for i in range(n):
            lo = int(starts[rank + i]) - base
            ln = int(lens[rank + i] & LEN_MASK)
            out[i] = _decompress(self._dctx, host[lo : lo + ln], bool(lens[rank + i] & RAW_BIT))
        return torch.from_numpy(out).to(payload.device)
