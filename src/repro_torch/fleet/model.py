"""Decomposed per-snapshot restore-cost profiles for the fleet driver.

A fleet simulation at 10k+ concurrent invocations cannot walk a
``SnapshotReader`` per invocation, so each function type's snapshot is
profiled ONCE into a :class:`RestoreProfile`: the same term-by-term
arithmetic as :func:`repro_torch.serve.strategies.modeled_concurrent_restore_s`
(metadata reads, borrow clflush, chunked hot pre-install, zero ranges,
doorbell-batched cold prefetch), but with the link-bound and CPU-bound
terms kept separate so the driver can re-price a restore under the host's
*current* conditions:

* **contention** — ``conc`` distinct fan-out groups actively restoring on
  the host share its CXL link and RNIC (`strategies._shared`, the same
  fair-share model the executed ``LinkArbiter`` path matches to ≤0.8%);
* **fan-out join** — a restore of a ``(name, version)`` already restoring
  on the host rides the existing group's tier reads (``HotChunkCache`` +
  shared cold extents) and pays only its own CPU-side installs;
* **dedup overlap** — hot chunks whose content is already resident on the
  host (a variant sharing base pages restored there before) hit the
  content-keyed chunk cache (``cross_group_hits``), removing that
  fraction of the CXL read.

``profile_reader`` is exact: at ``conc`` streams, no overlap and no join,
``RestoreProfile.cold_start_s`` reproduces ``modeled_concurrent_restore_s``
bit-for-bit (asserted in tests/test_torch_fleet.py).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core.pagestore import PAGE_SIZE
from ..core.pool import (
    CLFLUSH_PER_LINE_S,
    uffd_copy_batch_cost,
    uffd_zeropage_range_cost,
)
from ..serve.strategies import (
    CXL_BW,
    CXL_LAT_S,
    RDMA_BW,
    RDMA_INFLIGHT,
    RDMA_LAT_S,
    HOT_CHUNK_PAGES,
    _shared,
)


@dataclasses.dataclass(frozen=True)
class RestoreProfile:
    """Link-bound vs CPU-bound restore terms for one published snapshot."""

    name: str
    version: int
    total_pages: int
    hot_bytes: int               # hot payload crossing the CXL link
    cold_bytes: int              # cold payload crossing the RNIC
    # ms / oa / cold-index CXL reads as (serial_s, nbytes) terms — kept
    # separate because _shared is a max, not additive across regions
    meta_terms: Tuple[Tuple[float, int], ...]
    flush_s: float               # borrow-protocol clflushopt (CPU-side)
    hot_serial_s: float          # chunked CXL read, uncontended
    hot_chunks: int
    hot_install_s: float         # batched uffd.copy of the hot set
    zero_install_s: float        # uffd.zeropage ranges
    cold_serial_s: float         # doorbell-batched RDMA extent reads
    cold_install_s: float        # batched uffd.copy of the cold extents
    # dedup-overlap structure (placement scoring)
    shared_base_bytes: int = 0   # hot bytes shared with the base group
    exclusive_bytes: int = 0     # hot bytes exclusively ours (store truth)

    def cold_start_s(self, conc: int = 1, overlap_frac: float = 0.0,
                     joined: bool = False) -> float:
        """Modeled seconds for one full restore on a host where ``conc``
        distinct fan-out groups (including this one) contend for the links,
        ``overlap_frac`` of the hot bytes are already chunk-cache resident,
        and ``joined`` means an active same-snapshot group's reads are
        shared (this instance pays CPU-side installs only)."""
        conc = max(1, int(conc))
        # term order matches modeled_concurrent_restore_s exactly so that at
        # (conc, overlap=0, joined=False) the two are bit-identical
        t = 0.0
        for serial_s, nbytes in self.meta_terms:
            t += _shared(serial_s, nbytes, CXL_BW, conc)
        t += self.flush_s
        if not joined:
            f = float(np.clip(overlap_frac, 0.0, 1.0))
            eff_hot = int(round(self.hot_bytes * (1.0 - f))) if f > 0.0 \
                else self.hot_bytes
            if eff_hot > 0:
                serial = self.hot_serial_s if f == 0.0 else (
                    self.hot_chunks * (1.0 - f) * CXL_LAT_S
                    + eff_hot / CXL_BW)
                t += _shared(serial, eff_hot, CXL_BW, conc)
        if self.hot_bytes > 0:
            t += self.hot_install_s
        t += self.zero_install_s
        if not joined and self.cold_bytes > 0:
            t += _shared(self.cold_serial_s, self.cold_bytes, RDMA_BW, conc)
        if self.cold_bytes > 0:
            t += self.cold_install_s
        return t

    def install_only_s(self) -> float:
        """The fan-out joiner's cost (kept for reporting symmetry)."""
        return self.cold_start_s(1, joined=True)

    def scaled(self, k: float) -> "RestoreProfile":
        """Extrapolate to a k-x larger image (the ``Workload.scale`` idiom):
        every byte count, serial transfer, and install term grows by k, so
        the contention/overlap shape of the profiled layout is preserved
        while the bench models production-sized snapshots from small real
        pods."""
        if k == 1.0:
            return self
        mt = tuple((s * k, int(round(b * k))) for s, b in self.meta_terms)
        return dataclasses.replace(
            self,
            total_pages=int(round(self.total_pages * k)),
            hot_bytes=int(round(self.hot_bytes * k)),
            cold_bytes=int(round(self.cold_bytes * k)),
            meta_terms=mt,
            flush_s=self.flush_s * k,
            hot_serial_s=self.hot_serial_s * k,
            hot_chunks=max(1, int(round(self.hot_chunks * k)))
            if self.hot_chunks else 0,
            hot_install_s=self.hot_install_s * k,
            zero_install_s=self.zero_install_s * k,
            cold_serial_s=self.cold_serial_s * k,
            cold_install_s=self.cold_install_s * k,
            shared_base_bytes=int(round(self.shared_base_bytes * k)),
            exclusive_bytes=int(round(self.exclusive_bytes * k)),
        )


def profile_reader(reader, max_extent_pages: int = 64,
                   chunk_pages: int = HOT_CHUNK_PAGES,
                   shared_base_bytes: int = 0,
                   exclusive_bytes: int = 0) -> RestoreProfile:
    """Build a profile from a live ``SnapshotReader`` with exactly the term
    arithmetic of ``strategies.modeled_concurrent_restore_s`` — the two must
    agree bit-for-bit at (conc, overlap=0, joined=False)."""
    r = reader.regions
    oa_bytes = r.total_pages * 8
    meta_terms = [(CXL_LAT_S + r.ms_size / CXL_BW, r.ms_size),
                  (CXL_LAT_S + oa_bytes / CXL_BW, oa_bytes)]
    if r.cold_compressed and r.n_cold:
        ci_bytes = r.n_cold * 4
        meta_terms.append((CXL_LAT_S + ci_bytes / CXL_BW, ci_bytes))
    n_lines = -(-(r.ms_size + r.oa_size + max(r.hot_bytes, 0)) // 64)
    flush_s = n_lines * CLFLUSH_PER_LINE_S
    n_hot, n_chunks, n_ranges = 0, 0, 0
    for pages, _off, _nbytes in reader.iter_hot_extents(chunk_pages):
        n_chunks += 1
        n_hot += int(pages.size)
        seg = np.sort(pages)
        n_ranges += 1 + int(np.count_nonzero(np.diff(seg) != 1))
    hot_serial = (n_chunks * CXL_LAT_S + n_hot * PAGE_SIZE / CXL_BW
                  if n_hot else 0.0)
    hot_install = uffd_copy_batch_cost(n_hot, n_ranges) if n_hot else 0.0
    zr = reader.zero_runs()
    zero_install = (uffd_zeropage_range_cost(int(zr[:, 1].sum()),
                                             int(zr.shape[0]))
                    if zr.size else 0.0)
    cr = reader.cold_runs()
    n_cold = int(cr[:, 1].sum()) if cr.size else 0
    cold_serial, cold_bytes, cold_install = 0.0, 0, 0.0
    if n_cold:
        n_ext = 0
        for _es, _en, _rank0, _off, nbytes in reader.iter_cold_extents(
                max_extent_pages):
            cold_bytes += nbytes
            n_ext += 1
        cold_serial = (-(-n_ext // RDMA_INFLIGHT) * RDMA_LAT_S
                       + cold_bytes / RDMA_BW)
        cold_install = uffd_copy_batch_cost(n_cold, n_ext)
    return RestoreProfile(
        name=getattr(r, "name", ""), version=r.version,
        total_pages=r.total_pages,
        hot_bytes=n_hot * PAGE_SIZE, cold_bytes=cold_bytes,
        meta_terms=tuple(meta_terms), flush_s=flush_s,
        hot_serial_s=hot_serial, hot_chunks=n_chunks,
        hot_install_s=hot_install, zero_install_s=zero_install,
        cold_serial_s=cold_serial, cold_install_s=cold_install,
        shared_base_bytes=int(shared_base_bytes),
        exclusive_bytes=int(exclusive_bytes),
    )
