"""Hierarchical memory pool: pod-local CXL tier + cluster-wide RDMA tier.

Emulation strategy (no CXL MHD or RNIC is attached):

* **Data movement is real** — tiers are backed by ``torch.uint8`` arenas on
  the pool's device and every read/write actually copies bytes, so restore
  correctness is testable end-to-end (the restored state must be
  bit-identical to the published one).
* **Time is modeled** — each tier carries a ``CostModel`` from the paper and
  the pool accumulates modeled seconds per operation class.  Modeled seconds
  are not device times.
* **Non-coherence is emulated** — the CXL tier hands out per-host
  ``HostView``s with a private "CPU cache": reads are served from cached
  lines when present, so a host that skips the protocol's ``invalidate()``
  (clflushopt analogue) observably reads stale data.  The cache is a host
  bool per 64-byte line plus a device shadow of the arena, so a 1 MiB read
  is one copy of the missed lines, not a Python loop over 16k lines.

Cost-model constants:
  CXL   ~400 ns load-to-use, ~50 GB/s modeled link, uffd.copy ~1.1 µs/page,
        mmap install 2.6x uffd.copy (paper §2.3.4), clflushopt ~2 ns/line.
  RDMA  ~3 µs one-sided read latency, 100 Gb/s link, many ops in flight.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .clock import Clock, REAL_CLOCK
from .pagestore import PAGE_SIZE, resolve_device

CACHELINE = 64

# Backend tags (encoded in the offset array's top bits, see snapshot.py).
TIER_CXL = 0
TIER_RDMA = 1


@dataclasses.dataclass
class CostModel:
    """Per-tier latency/bandwidth model; times in seconds, sizes in bytes."""

    op_latency_s: float          # fixed per-operation cost (load-to-use / RDMA op)
    bandwidth_Bps: float         # sustained sequential bandwidth
    max_inflight: int = 1        # concurrent ops the fabric sustains (RDMA QP depth)

    def xfer_time(self, nbytes: int, ops: int = 1) -> float:
        """Modeled time for `ops` transfers totalling `nbytes`, serialized."""
        return ops * self.op_latency_s + nbytes / self.bandwidth_Bps

    def xfer_time_pipelined(self, nbytes: int, ops: int) -> float:
        """Latency hidden by max_inflight concurrent ops (one-sided RDMA)."""
        serial_ops = -(-ops // max(1, self.max_inflight))
        return serial_ops * self.op_latency_s + nbytes / self.bandwidth_Bps


# Defaults from the paper's figures; identical to the reference package.
CXL_COST = CostModel(op_latency_s=400e-9, bandwidth_Bps=50e9, max_inflight=1)
RDMA_COST = CostModel(op_latency_s=3e-6, bandwidth_Bps=100e9 / 8, max_inflight=64)
# uffd ioctl cost split: a fixed syscall/wakeup component amortized over a
# contiguous range, plus an incremental per-4KiB-page copy component.  The
# single-page constants below are their sum, so the batched and per-page
# paths agree exactly at n=1 and batching can only amortize, never undercount.
UFFD_IOCTL_S = 0.6e-6                  # fixed cost per uffd.copy ioctl (syscall+wake)
UFFD_COPY_PAGE_S = 0.5e-6              # per-page copy within one uffd.copy range
UFFD_ZEROPAGE_IOCTL_S = 0.4e-6         # fixed cost per uffd.zeropage ioctl (no copy setup)
UFFD_ZEROPAGE_PAGE_S = 0.15e-6         # per-page cost within one uffd.zeropage range
UFFD_COPY_PER_PAGE_S = UFFD_IOCTL_S + UFFD_COPY_PAGE_S        # 1.1 µs single page
UFFD_ZEROPAGE_PER_PAGE_S = UFFD_ZEROPAGE_IOCTL_S + UFFD_ZEROPAGE_PAGE_S  # 0.55 µs
MMAP_PER_PAGE_S = UFFD_COPY_PER_PAGE_S * 2.6   # paper: mmap 2.6x slower per page
MMAP_SYSCALL_S = 1.0e-6     # fixed mmap()+setup cost per mapped range (§2.3.4)
CLFLUSH_PER_LINE_S = 2e-9   # clflushopt of *uncached* lines: ~issue cost


def uffd_copy_batch_cost(n_pages: int, n_ranges: int = 1) -> float:
    """Modeled cost of installing `n_pages` via `n_ranges` uffd.copy ioctls."""
    return n_ranges * UFFD_IOCTL_S + n_pages * UFFD_COPY_PAGE_S


def uffd_zeropage_range_cost(n_pages: int, n_ranges: int = 1) -> float:
    """Modeled cost of zero-filling `n_pages` via `n_ranges` uffd.zeropage ioctls."""
    return n_ranges * UFFD_ZEROPAGE_IOCTL_S + n_pages * UFFD_ZEROPAGE_PAGE_S


class AllocError(RuntimeError):
    """A tier allocation could not be satisfied (capacity or fragmentation)."""


class CXLBudget:
    """Per-pod byte budget over snapshot CXL regions (Pond-style capacity
    management): the gauge :class:`~repro_torch.core.master.CXLCapacityManager`
    syncs via :meth:`set_usage`, and its admission and eviction counters.
    """

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._in_use = 0
        self.stats = {"admitted": 0, "degraded": 0, "demotions": 0,
                      "sweeps": 0, "shared_skips": 0}

    @property
    def in_use(self) -> int:
        with self._lock:
            return self._in_use

    def set_usage(self, nbytes: int) -> None:
        with self._lock:
            self._in_use = int(nbytes)

    def report(self) -> Dict[str, int]:
        with self._lock:
            return {"budget_bytes": self.budget_bytes, "in_use": self._in_use,
                    **self.stats}


class LinkArbiter:
    """Contention-aware modeled time for one host's link to a tier.

    Streams that offer traffic to the link register for their active
    restore window.  Each modeled transfer is charged

        max(serial_time,  nbytes * active_streams / bandwidth)

    i.e. its own serial pipeline time or its fair share of the link,
    whichever is slower.  With at most one stream registered every charge
    equals the uncontended serial time.
    """

    def __init__(self, cost: CostModel):
        self.cost = cost
        self._lock = threading.Lock()
        self._streams: Dict[object, int] = {}

    def register(self, key: object) -> None:
        """Refcounted: k registrations of one key count as ONE stream."""
        with self._lock:
            self._streams[key] = self._streams.get(key, 0) + 1

    def unregister(self, key: object) -> None:
        with self._lock:
            n = self._streams.get(key, 0) - 1
            if n <= 0:
                self._streams.pop(key, None)
            else:
                self._streams[key] = n

    def active(self) -> int:
        with self._lock:
            return max(1, len(self._streams))

    def shared(self, serial_s: float, nbytes: int) -> float:
        """max(serial, fair-share-bandwidth time)."""
        return max(serial_s, nbytes * self.active() / self.cost.bandwidth_Bps)

    def charge(self, nbytes: int, ops: int = 1) -> float:
        return self.shared(self.cost.xfer_time(nbytes, ops), nbytes)

    def charge_pipelined(self, nbytes: int, ops: int) -> float:
        return self.shared(self.cost.xfer_time_pipelined(nbytes, ops), nbytes)


@dataclasses.dataclass
class TimeLedger:
    """Accumulated modeled time, by operation class."""

    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, key: str, t: float) -> None:
        self.seconds[key] = self.seconds.get(key, 0.0) + t

    def total(self) -> float:
        return sum(self.seconds.values())

    def merge(self, other: "TimeLedger") -> None:
        for k, v in other.seconds.items():
            self.add(k, v)


class MemoryTier:
    """One tier of the pool: a device byte arena + first-fit allocator + cost model."""

    def __init__(self, name: str, capacity: int, cost: CostModel, device="cuda"):
        self.name = name
        self.capacity = capacity
        self.cost = cost
        self.buf = torch.zeros(capacity, dtype=torch.uint8, device=resolve_device(device))
        self._lock = threading.Lock()
        self._free: List[Tuple[int, int]] = [(0, capacity)]  # (offset, size), sorted
        self.bytes_in_use = 0
        self._arbiters: Dict[str, LinkArbiter] = {}
        # fault-tolerance seam: both default to inert.  ``fault_injector``
        # is the deterministic fault schedule (None = the fault-free path);
        # ``health`` is the per-tier circuit breaker serving consults before
        # host-link reads.
        self.fault_injector = None
        self.health = None
        # back-pointer to this tier's content-addressed store (set by
        # DedupStore); checksum repair resolves the store from the tier
        self.dedup_store = None

    @property
    def device(self) -> torch.device:
        return self.buf.device

    def arbiter_for(self, host: str = "") -> LinkArbiter:
        """The contention arbiter for `host`'s link to this tier."""
        with self._lock:
            arb = self._arbiters.get(host)
            if arb is None:
                arb = self._arbiters[host] = LinkArbiter(self.cost)
            return arb

    # -- allocator --------------------------------------------------------
    def alloc(self, nbytes: int) -> int:
        nbytes = max(1, -(-nbytes // PAGE_SIZE) * PAGE_SIZE)
        with self._lock:
            for i, (off, size) in enumerate(self._free):
                if size >= nbytes:
                    if size == nbytes:
                        self._free.pop(i)
                    else:
                        self._free[i] = (off + nbytes, size - nbytes)
                    self.bytes_in_use += nbytes
                    return off
        raise self._alloc_error(nbytes)

    def _alloc_error(self, nbytes: int) -> AllocError:
        err = AllocError(f"tier {self.name}: cannot alloc {nbytes} B "
                         f"({self.bytes_in_use}/{self.capacity} in use)")
        err.tier = self.name    # which tier failed (degrade paths branch on it)
        return err

    def alloc_pages(self, k: int) -> np.ndarray:
        """Up to ``k`` single pages, first fit: exactly the offsets (in
        order) and the free list that ``k`` calls of ``alloc(PAGE_SIZE)``
        leave, stopping where such a call would raise.  Returns int64
        offsets; fewer than ``k`` means the tier ran out (the caller raises
        :meth:`_alloc_error` if it needs them all)."""
        got: List[np.ndarray] = []
        need = int(k)
        with self._lock:
            i = 0
            while need and i < len(self._free):
                off, size = self._free[i]
                take = min(need, size // PAGE_SIZE)
                if take == 0:
                    i += 1
                    continue
                got.append(off + PAGE_SIZE * np.arange(take, dtype=np.int64))
                need -= take
                self.bytes_in_use += take * PAGE_SIZE
                if size == take * PAGE_SIZE:
                    self._free.pop(i)
                else:
                    self._free[i] = (off + take * PAGE_SIZE, size - take * PAGE_SIZE)
                    i += 1
        return np.concatenate(got) if got else np.zeros(0, dtype=np.int64)

    def page_rows(self) -> torch.Tensor:
        """The arena's whole pages as a ``(capacity // PAGE_SIZE, PAGE_SIZE)``
        view: row ``off // PAGE_SIZE`` holds the page at byte ``off``."""
        n = self.capacity // PAGE_SIZE
        return self.buf[: n * PAGE_SIZE].view(n, PAGE_SIZE)

    def free(self, offset: int, nbytes: int) -> None:
        """Return a block: O(log n) position search + O(1) neighbor merge
        (the free list is kept sorted and fully coalesced at all times)."""
        nbytes = max(1, -(-nbytes // PAGE_SIZE) * PAGE_SIZE)
        with self._lock:
            i = bisect.bisect_left(self._free, (offset, 0))
            prev_adj = i > 0 and self._free[i - 1][0] + self._free[i - 1][1] == offset
            next_adj = i < len(self._free) and offset + nbytes == self._free[i][0]
            if prev_adj and next_adj:
                po, ps = self._free[i - 1]
                self._free[i - 1] = (po, ps + nbytes + self._free[i][1])
                self._free.pop(i)
            elif prev_adj:
                po, ps = self._free[i - 1]
                self._free[i - 1] = (po, ps + nbytes)
            elif next_adj:
                no, ns = self._free[i]
                self._free[i] = (offset, nbytes + ns)
            else:
                self._free.insert(i, (offset, nbytes))
            self.bytes_in_use -= nbytes

    def free_list_stats(self) -> Dict[str, int]:
        """Fragmentation snapshot: block count + total free bytes."""
        with self._lock:
            return {"blocks": len(self._free),
                    "free_bytes": sum(s for _o, s in self._free)}

    def free_list(self) -> List[Tuple[int, int]]:
        """Copy of the sorted, coalesced ``(offset, size)`` free list."""
        with self._lock:
            return list(self._free)

    # -- raw access (owner-side; bypasses host caches) ---------------------
    def write(self, offset: int, data: torch.Tensor) -> None:
        raw = data.reshape(-1).view(torch.uint8)
        if self.fault_injector is not None:
            self.fault_injector.check_write(self.name, offset, raw.numel())
        self.buf[offset : offset + raw.numel()].copy_(raw)

    def read(self, offset: int, nbytes: int) -> torch.Tensor:
        fi = self.fault_injector
        if fi is not None:
            fi.check_read(self.name, offset, nbytes)
        data = self.buf[offset : offset + nbytes].clone()
        if fi is not None:
            fi.filter_read(self.name, offset, nbytes, data)
        return data


def _runs(idx: np.ndarray):
    """``(start, stop)`` pairs of the maximal consecutive runs of sorted ``idx``."""
    brk = np.flatnonzero(np.diff(idx) != 1)
    starts = np.concatenate([[0], brk + 1])
    stops = np.concatenate([brk, [idx.size - 1]])
    return zip(idx[starts].tolist(), (idx[stops] + 1).tolist())


class HostView:
    """A host's view of the CXL tier, with an *incoherent* private cache.

    Reads populate the cache; later reads hit it even if the underlying pool
    bytes changed — exactly the CXL 2.0 MHD hazard (§2.3.2).  ``invalidate``
    is the clflushopt analogue and also charges the modeled flush cost.

    The cache is vectorized: ``_valid`` is a host bool per 64-byte line and
    ``_shadow`` a device copy of the arena that holds the cached lines.  A
    read copies only the missed lines from the tier into the shadow, marks
    them valid, and returns a clone of the shadow range — the same bytes and
    the same line counts as a per-line dictionary cache.
    """

    def __init__(self, host: str, tier: MemoryTier, ledger: Optional[TimeLedger] = None):
        self.host = host
        self.tier = tier
        self.ledger = ledger or TimeLedger()
        self.arbiter = tier.arbiter_for(host)
        self._valid = np.zeros(-(-tier.capacity // CACHELINE), dtype=bool)
        self._shadow: Optional[torch.Tensor] = None     # allocated on first read
        self.stats = {"cached_reads": 0, "pool_reads": 0, "flushed_lines": 0,
                      "bytes_read": 0}

    def read_charged(self, offset: int, nbytes: int) -> Tuple[torch.Tensor, float]:
        """Like :meth:`read`, also returning the modeled seconds charged."""
        fi = self.tier.fault_injector
        if fi is not None:
            # the host CXL.mem link: brownout windows apply here (owner-side
            # pool-fabric reads via MemoryTier.read are NOT browned out)
            fi.check_read(self.tier.name, offset, nbytes, host_link=True)
        if self._shadow is None:
            self._shadow = torch.empty_like(self.tier.buf)
        first = offset // CACHELINE
        last = (offset + nbytes - 1) // CACHELINE
        valid = self._valid[first : last + 1]
        missed = np.flatnonzero(~valid) + first
        if missed.size:
            for a, b in _runs(missed):
                lo, hi = a * CACHELINE, min(b * CACHELINE, self.tier.capacity)
                self._shadow[lo:hi].copy_(self.tier.buf[lo:hi])
            valid[:] = True
        self.stats["pool_reads"] += int(missed.size)
        self.stats["cached_reads"] += int(valid.size - missed.size)
        out = self._shadow[offset : offset + nbytes].clone()
        self.stats["bytes_read"] += nbytes
        if fi is not None:
            # poison the returned copy only — the line cache and the pool
            # bytes stay clean, so a budgeted re-read repairs the page
            fi.filter_read(self.tier.name, offset, nbytes, out)
        t = self.arbiter.charge(nbytes)
        self.ledger.add("cxl_read", t)
        return out, t

    def read(self, offset: int, nbytes: int) -> torch.Tensor:
        return self.read_charged(offset, nbytes)[0]

    def read_page(self, offset: int) -> torch.Tensor:
        return self.read(offset, PAGE_SIZE)

    def invalidate(self, offset: int, nbytes: int) -> None:
        """clflushopt over [offset, offset+nbytes): drop cached lines."""
        first = offset // CACHELINE
        last = (offset + nbytes - 1) // CACHELINE
        self._valid[first : last + 1] = False
        self.stats["flushed_lines"] += last - first + 1
        self.ledger.add("clflush", (last - first + 1) * CLFLUSH_PER_LINE_S)

    def drop_all(self) -> None:
        self._valid[:] = False

    def has_valid_lines(self, offsets, nbytes: int) -> bool:
        """Whether a cached (valid) line overlaps ``[off, off + nbytes)`` for
        any ``off`` of ``offsets``: a read there could return cached bytes
        instead of the pool's.  A query only: no stats, no fills."""
        offs = np.asarray(offsets, dtype=np.int64).reshape(-1)
        per = nbytes // CACHELINE
        if nbytes % CACHELINE == 0 and not (offs % nbytes).any():
            # aligned blocks: the lines of block k are row k of the bitmap
            blocks = self._valid[: self._valid.size - self._valid.size % per]
            return bool(blocks.reshape(-1, per)[offs // nbytes].any())
        return any(self._valid[o // CACHELINE : (o + nbytes - 1) // CACHELINE + 1].any()
                   for o in offs.tolist())


class HierarchicalPool:
    """The two-tier pool a pod sees: CXL (fast/near) + RDMA (big/far).

    Both arenas live on ``device``, each with a content-addressed page store
    (``dedup_cxl`` / ``dedup_rdma``) that dedup publishes route pages through.
    """

    def __init__(
        self,
        cxl_capacity: int = 256 << 20,
        rdma_capacity: int = 1 << 30,
        cxl_cost: CostModel = CXL_COST,
        rdma_cost: CostModel = RDMA_COST,
        clock: Optional[Clock] = None,
        device="cuda",
        dedup_hash_fn=None,
    ):
        # The pool is the one object every component of a pod shares, so it
        # carries the pod's time source.
        self.clock = clock or REAL_CLOCK
        self.device = resolve_device(device)
        self.fault_injector = None
        self.cxl = MemoryTier("cxl", cxl_capacity, cxl_cost, self.device)
        self.rdma = MemoryTier("rdma", rdma_capacity, rdma_cost, self.device)
        # content-addressed page stores (one per tier): dedup publishes route
        # page payloads through these, and the offset array then points at
        # refcounted absolute tier offsets.  ``dedup_hash_fn`` is the stores'
        # hash seam: pass ``dedup.poly32_hash_fn`` and the fused publish
        # sweep's checksum column doubles as the stores' hash input.
        from .dedup import DedupStore  # local import: dedup imports pool

        self.dedup_cxl = DedupStore(self.cxl, hash_fn=dedup_hash_fn)
        self.dedup_rdma = DedupStore(self.rdma, hash_fn=dedup_hash_fn)
        # per-tier circuit breakers; inert until a failure
        from .faults import TierHealth

        self.health = {"cxl": TierHealth("cxl", self.clock),
                       "rdma": TierHealth("rdma", self.clock)}
        self.cxl.health = self.health["cxl"]
        self.rdma.health = self.health["rdma"]

    def attach_fault_injector(self, injector) -> None:
        """Arm the deterministic fault seam on both tiers (None to disarm)."""
        self.fault_injector = injector
        self.cxl.fault_injector = injector
        self.rdma.fault_injector = injector

    def dedup_store(self, tag: int):
        if tag == TIER_CXL:
            return self.dedup_cxl
        if tag == TIER_RDMA:
            return self.dedup_rdma
        raise ValueError(f"unknown tier tag {tag}")

    def tier(self, tag: int) -> MemoryTier:
        if tag == TIER_CXL:
            return self.cxl
        if tag == TIER_RDMA:
            return self.rdma
        raise ValueError(f"unknown tier tag {tag}")

    def host_view(self, host: str, ledger: Optional[TimeLedger] = None) -> HostView:
        return HostView(host, self.cxl, ledger)
