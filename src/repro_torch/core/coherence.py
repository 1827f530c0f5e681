"""Ownership-based coherence protocol for non-coherent shared CXL memory (§3.3).

CXL 2.0 MHDs give multiple hosts load/store access to the same bytes with
**no inter-host cache coherence**.  Aquifer sidesteps general coherence by
construction:

* snapshot data is **immutable while borrowed** — borrowers only read;
* the only mutable shared words are each catalog entry's ``state`` and
  ``refcount``, manipulated **only with atomic operations** (assumed per
  [49]; the ``LeaseFallback`` below covers devices without cross-host
  atomics);
* a successful borrow is followed by ``clflushopt`` over the snapshot's CXL
  sections so subsequent loads observe current bytes (HostView.invalidate).

Protocol (verbatim from the paper):
  borrow:   refcount.fetch_add(1); CAS(state, PUBLISHED→PUBLISHED).
            CAS failure ⇒ entry is tombstoned ⇒ refcount.fetch_sub(1) and
            fall back to cold start.  Incrementing refcount *first* closes
            the window where the owner could see refcount==0 mid-borrow.
  release:  refcount.fetch_sub(1).
  owner:    delete  = state←TOMBSTONE; reclaim data only once refcount==0.
            update  = state←TOMBSTONE; wait refcount==0; rewrite data;
                      state←PUBLISHED (refcount already 0).
            add     = pick a TOMBSTONE entry with refcount==0; write data;
                      state←PUBLISHED.

The catalog is host control state: plain Python words and locks in the same
order as the reference package, whatever device the snapshot's bytes live on.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from .clock import Clock, REAL_CLOCK
from .snapshot import SnapshotRegions

# Catalog entry states.
STATE_FREE = 0         # never used / fully reclaimed
STATE_PUBLISHED = 1
STATE_TOMBSTONE = 2


class AtomicU64:
    """Linearizable 64-bit atomic cell (stand-in for CXL cross-host atomics)."""

    __slots__ = ("_v", "_lock")

    def __init__(self, value: int = 0):
        self._v = value
        self._lock = threading.Lock()

    def load(self) -> int:
        with self._lock:
            return self._v

    def store(self, value: int) -> None:
        with self._lock:
            self._v = value

    def fetch_add(self, delta: int) -> int:
        with self._lock:
            old = self._v
            self._v += delta
            return old

    def compare_exchange(self, expected: int, desired: int) -> bool:
        with self._lock:
            if self._v == expected:
                self._v = desired
                return True
            return False

    def exchange(self, desired: int) -> int:
        with self._lock:
            old = self._v
            self._v = desired
            return old


@dataclasses.dataclass
class CatalogEntry:
    """One slot of the snapshot catalog, resident in CXL memory."""

    index: int
    state: AtomicU64 = dataclasses.field(default_factory=lambda: AtomicU64(STATE_FREE))
    refcount: AtomicU64 = dataclasses.field(default_factory=AtomicU64)
    borrow_counter: AtomicU64 = dataclasses.field(default_factory=AtomicU64)  # §3.6 eviction
    # clock-eviction metadata (CXLCapacityManager): the reference bit gives
    # borrowed-since-last-sweep second chances, the timestamp records restore
    # recency for introspection/LRU tie-breaks.
    referenced: AtomicU64 = dataclasses.field(default_factory=AtomicU64)
    last_borrow_s: float = 0.0
    # Region record (rewritten only by the owner while TOMBSTONE & refcount==0).
    regions: Optional[SnapshotRegions] = None
    name: str = ""
    version: int = 0


class Borrow:
    """RAII-ish handle for an established borrow."""

    def __init__(self, entry: CatalogEntry, on_release: Callable[[], None]):
        self.entry = entry
        self.regions = entry.regions
        self.version = entry.version
        self._on_release = on_release
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self.entry.refcount.fetch_add(-1)
            self._on_release()

    def __enter__(self) -> "Borrow":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class Catalog:
    """Fixed-size snapshot catalog shared by the pool master + orchestrators."""

    def __init__(self, capacity: int = 256, clock: Optional[Clock] = None):
        self.entries: List[CatalogEntry] = [CatalogEntry(i) for i in range(capacity)]
        self.clock = clock or REAL_CLOCK
        self._by_name_lock = threading.Lock()
        self._by_name: Dict[str, int] = {}

    # -- lookup -------------------------------------------------------------
    def find(self, name: str) -> Optional[CatalogEntry]:
        with self._by_name_lock:
            idx = self._by_name.get(name)
        return self.entries[idx] if idx is not None else None

    def _bind(self, name: str, index: int) -> None:
        with self._by_name_lock:
            self._by_name[name] = index

    def _unbind(self, name: str) -> None:
        with self._by_name_lock:
            self._by_name.pop(name, None)

    # -- borrower side (§3.3 Borrow protocol) ---------------------------------
    def borrow_steps(self, name: str, noop=lambda: None,
                     state_precheck: bool = True) -> Iterator[Tuple[str, object]]:
        """Generator form of :meth:`borrow`, yielding at the protocol's
        inter-host visibility points so a deterministic scheduler
        can interleave other hosts *between* the refcount increment and the
        state CAS.  Yields ``(label, value)``:

        * ``("refcount_incremented", entry)`` — increment done, CAS pending;
        * ``("doomed", entry)``  — CAS failed, increment already backed out;
        * ``("done", Borrow | None)`` — terminal; None ⇒ caller cold-starts.

        ``state_precheck=False`` skips the fast-path state test that keeps
        doomed borrows rare, for tests that reproduce the livelock it
        prevents.
        """
        entry = self.find(name)
        if entry is None:
            yield ("done", None)
            return
        # 0) fast-path reject on a non-published entry WITHOUT touching the
        # refcount.  Doomed borrows (inc → CAS-fail → dec) are protocol-safe
        # but their transient increments can livelock the owner's
        # wait-for-drain when borrowers retry in a tight loop; testing the
        # state first makes them rare.  A stale PUBLISHED read here only
        # leads to the doomed-borrow path below, which remains correct.
        if state_precheck and entry.state.load() != STATE_PUBLISHED:
            yield ("done", None)
            return
        # 1) refcount++ first (closes the owner-sees-zero window)
        entry.refcount.fetch_add(1)
        yield ("refcount_incremented", entry)
        # 2) CAS state expecting PUBLISHED — atomic, ordered after the increment
        if entry.state.compare_exchange(STATE_PUBLISHED, STATE_PUBLISHED):
            entry.borrow_counter.fetch_add(1)
            entry.referenced.store(1)
            entry.last_borrow_s = self.clock.monotonic()
            yield ("done", Borrow(entry, noop))
            return
        # CAS failed: snapshot is being reclaimed → back out, cold start
        entry.refcount.fetch_add(-1)
        yield ("doomed", entry)
        yield ("done", None)

    def borrow(self, name: str, noop=lambda: None) -> Optional[Borrow]:
        result: Optional[Borrow] = None
        for label, value in self.borrow_steps(name, noop):
            if label == "done":
                result = value
        return result

    # -- owner side (pool master only) ----------------------------------------
    def publish_new(self, name: str, regions: SnapshotRegions, version: int = 0) -> CatalogEntry:
        entry = self._claim_reusable_entry()
        entry.regions = regions
        entry.name = name
        entry.version = version
        entry.borrow_counter.store(0)
        entry.referenced.store(0)
        entry.last_borrow_s = 0.0
        assert entry.refcount.load() == 0
        self._bind(name, entry.index)
        ok = entry.state.compare_exchange(entry.state.load(), STATE_PUBLISHED)
        assert ok
        return entry

    def tombstone(self, name: str) -> Optional[CatalogEntry]:
        """Prevent new borrows; in-flight borrows continue until release."""
        entry = self.find(name)
        if entry is None:
            return None
        entry.state.store(STATE_TOMBSTONE)
        return entry

    def wait_unborrowed(self, entry: CatalogEntry, timeout_s: float = 30.0) -> bool:
        deadline = self.clock.monotonic() + timeout_s
        while entry.refcount.load() != 0:
            if self.clock.monotonic() > deadline:
                return False
            self.clock.sleep(1e-5)
        return True

    def republish(self, entry: CatalogEntry, regions: SnapshotRegions, version: int) -> None:
        """Owner update: caller must hold TOMBSTONE state after a drain.

        Note: refcount may be transiently nonzero here — a *doomed* borrow
        (refcount++ already done, state CAS about to fail) never reads data,
        so the rewrite/republish is safe; only successful borrows matter,
        and those are excluded by the TOMBSTONE state."""
        assert entry.state.load() == STATE_TOMBSTONE
        entry.regions = regions
        entry.version = version
        ok = entry.state.compare_exchange(STATE_TOMBSTONE, STATE_PUBLISHED)
        assert ok

    def reclaim(self, entry: CatalogEntry) -> None:
        """Logical delete → FREE once the last successful borrow drains
        (transient doomed-borrow increments are harmless, see republish)."""
        assert entry.state.load() == STATE_TOMBSTONE
        self._unbind(entry.name)
        entry.regions = None
        entry.name = ""
        entry.state.store(STATE_FREE)

    def _claim_reusable_entry(self) -> CatalogEntry:
        # Prefer FREE slots; else TOMBSTONE slots whose refcount drained (§3.3 Add).
        for entry in self.entries:
            if entry.state.load() == STATE_FREE:
                if entry.state.compare_exchange(STATE_FREE, STATE_TOMBSTONE):
                    if entry.refcount.load() == 0:
                        return entry
        for entry in self.entries:
            if (
                entry.state.load() == STATE_TOMBSTONE
                and entry.refcount.load() == 0
                and entry.regions is None
                and not entry.name      # still-bound entries are mid-update
            ):
                return entry
        raise RuntimeError("catalog full")


class LeaseFallback:
    """§3.6: RDMA-RPC leases for CXL pools without cross-host atomics.

    All orchestrators talk to the pool master, which serializes lease
    grant/release against update/delete.  Same observable semantics as the
    atomic protocol, at the cost of one RPC per restore and one per shutdown.
    """

    def __init__(self, catalog: Catalog, rpc_latency_s: float = 10e-6):
        self.catalog = catalog
        self.rpc_latency_s = rpc_latency_s
        self._lock = threading.Lock()   # the pool master's serialization point
        self.rpc_count = 0

    def acquire(self, name: str) -> Optional[Borrow]:
        with self._lock:
            self.rpc_count += 1
            entry = self.catalog.find(name)
            if entry is None or entry.state.load() != STATE_PUBLISHED:
                return None
            entry.refcount.fetch_add(1)
            entry.borrow_counter.fetch_add(1)
            entry.referenced.store(1)
            entry.last_borrow_s = self.catalog.clock.monotonic()
            return Borrow(entry, self._on_release)

    def _on_release(self) -> None:
        with self._lock:
            self.rpc_count += 1
