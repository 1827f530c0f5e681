"""Pool master: sole owner of pool-side snapshot storage (§3.1, §3.3, §3.6).

Responsibilities: publish / update / delete snapshots under the ownership
protocol, reclaim tombstoned regions once their refcount drains, and run the
borrow-counter based CXL eviction policy (§3.6).  Content-hash deduplication
(§3.6) is an optional layer applied at publish time.

Beyond the paper: a per-pod CXL capacity manager (clock eviction over
snapshot hot regions, degrade-to-RDMA on over-subscription).  The
heat-feedback re-curation pipeline (``recurate``) raises
``NotImplementedError``: it needs ``plan_recuration`` (ROADMAP A4c) and the
break-even model ``recuration_economics`` (ROADMAP A8).

The publish sweep enters through ``publish_fn``: with a CUDA pool, pass
``kernels.make_fused_publish_fn()`` and every publish this master drives is
one launch of the fused publish kernel.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .clock import Clock, REAL_CLOCK
from .coherence import STATE_PUBLISHED, STATE_TOMBSTONE, Catalog, CatalogEntry
from .pagestore import StateImage
from .pool import AllocError, CXLBudget, HierarchicalPool
from .snapshot import (
    SnapshotRegions,
    build_snapshot,
    estimate_snapshot_cxl_size,
    exclusive_cxl_bytes,
    free_snapshot,
    reconstruct_image,
)

_RECURATE_TODO = ("PoolMaster.recurate is not ported yet: it needs plan_recuration "
                  "(ROADMAP A4c) and recuration_economics (ROADMAP A8)")


class CXLCapacityManager:
    """Per-pod CXL budget enforcement with clock eviction (§3.6 grown up).

    Admission: before a publish builds its CXL region, the master asks
    :meth:`admit` whether the estimated bytes fit the pod budget.  When they
    do not, a clock hand sweeps the catalog's published snapshots:

    * entries borrowed since the last sweep carry a ``referenced`` bit —
      the hand clears it and gives them a second chance (clock ≈ LRU by
      restore recency without a sorted list in shared memory);
    * entries with a nonzero refcount are SKIPPED, never evicted — a live
      borrow (including fan-out restores holding ``HotChunkCache`` chunks
      borrowed against the entry) pins the hot region;
    * the victim is *demoted*, not deleted: its image is reconstructed and
      republished with an empty working set through the ownership protocol,
      so its hot region moves to RDMA and later restores degrade to
      demand-paging instead of disappearing.

    When even a full sweep cannot make room, :meth:`admit` returns False
    and the caller publishes the NEW snapshot all-cold (hot set spilled to
    RDMA) — over-subscription degrades, it never fails ``alloc``.
    """

    def __init__(self, master: "PoolMaster", budget_bytes: int,
                 demote_drain_timeout_s: float = 0.25):
        self.master = master
        self.budget = CXLBudget(budget_bytes)
        self.demote_drain_timeout_s = demote_drain_timeout_s
        self._hand = 0
        self._lock = threading.Lock()

    def usage(self) -> int:
        """Authoritative: sum of live catalog entries' CXL regions (the
        gauge in :class:`~repro_torch.core.pool.CXLBudget` is synced from this,
        so accounting can never drift from the shared truth).  Each entry's
        ``regions`` is read ONCE — a concurrent update may null it between
        a check and a re-read.

        Dedup snapshots contribute only their private metadata region here;
        their page payloads are accounted ONCE, as the content store's
        unique bytes — publishing ten variants of one base costs the budget
        one copy of the shared pages plus each variant's deltas."""
        regions = [e.regions for e in self.master.catalog.entries]
        total = sum(r.cxl_size for r in regions if r is not None)
        total += self.master.pool.dedup_cxl.unique_bytes()
        self.budget.set_usage(total)
        return total

    def admit(self, needed_bytes: int, exclude_name: str = "") -> bool:
        """True ⇒ the CXL region fits (possibly after demotions); False ⇒
        caller must degrade the publish to RDMA."""
        with self._lock:
            budget = self.budget.budget_bytes
            usage = self.usage()
            if usage + needed_bytes <= budget:
                self.budget.stats["admitted"] += 1
                return True
            self.budget.stats["sweeps"] += 1
            # Incremental sweep: ``usage()`` is a full O(catalog) region sum
            # plus a dedup-store scan, so recomputing it per demotion made
            # the sweep O(victims x catalog).  Each victim instead reports
            # the bytes its demotion actually freed (old-minus-new private
            # region + store-unique delta) and the running gauge is
            # decremented — one recompute at entry, one at exit.
            while usage + needed_bytes > budget:
                freed = self._demote_one(exclude_name)
                if freed is None:
                    break
                usage -= freed
            # conservation check: the incremental estimate must agree with
            # the authoritative recompute (which also re-syncs the gauge) —
            # a drift here means a victim mis-reported its freed bytes
            actual = self.usage()
            assert usage == actual, (
                f"capacity sweep conservation: incremental usage {usage} "
                f"!= recomputed {actual}")
            if actual + needed_bytes <= budget:
                self.budget.stats["admitted"] += 1
                return True
            self.budget.stats["degraded"] += 1
            return False

    def _demote_one(self, exclude_name: str) -> Optional[int]:
        """One clock sweep: demote the first unreferenced, unborrowed
        published snapshot with a non-empty hot region.  Two full rounds so
        every referenced bit can be cleared once before we give up.
        Returns the CXL bytes the demotion freed (for the caller's
        incremental usage accounting), or None when no victim demoted —
        including the empty-catalog and everything-excluded cases."""
        entries = self.master.catalog.entries
        n = len(entries)
        for _ in range(2 * n):
            entry = entries[self._hand % n]
            self._hand += 1
            r = entry.regions
            if (entry.state.load() != STATE_PUBLISHED or r is None
                    or not entry.name or entry.name == exclude_name
                    or r.hot_bytes <= 0):
                continue
            if entry.referenced.exchange(0):
                continue                      # second chance (recently restored)
            if entry.refcount.load() != 0:
                continue                      # pinned by live borrows / fan-out
            name = entry.name
            # pin the regions while READING them (exclusive-footprint scoring
            # decodes the stored offset array, materialization reads the data
            # pages): a concurrent owner op on this name cannot free bytes we
            # are still reading.  Released BEFORE the demoting publish — our
            # own pin would deadlock its drain otherwise.
            pin = self.master.catalog.borrow(name)
            if pin is None or pin.regions is not r:
                if pin is not None:
                    pin.release()
                continue                      # owner op raced us: skip victim
            try:
                image = None
                if exclusive_cxl_bytes(self.master.pool, r) <= 0:
                    # every hot page is shared with another live snapshot:
                    # demoting this victim frees ~nothing (the content store
                    # keeps the pages for its co-owners), so the clock skips it
                    self.budget.stats["shared_skips"] += 1
                else:
                    image = reconstruct_image(self.master.pool, r)
            finally:
                pin.release()
                # our own pin set the reference bit — clear it so a FAILED
                # demotion does not grant the victim an unearned second
                # chance on every later sweep
                entry.referenced.store(0)
            if image is None:
                continue
            # measure what this demotion frees WITHOUT a full recompute: the
            # victim's private CXL region shrinks (hot data moves to RDMA)
            # and, for dedup victims, the store releases this snapshot's
            # exclusive pages (shared pages stay for their co-owners)
            old_cxl = r.cxl_size
            unique_before = self.master.pool.dedup_cxl.unique_bytes()
            if not self._demote_publish(name, image, r.version, dedup=r.dedup):
                continue                      # a borrow landed mid-drain: skip
            self.budget.stats["demotions"] += 1
            new_entry = self.master.catalog.find(name)
            new_cxl = (new_entry.regions.cxl_size
                       if new_entry is not None and new_entry.regions is not None
                       else 0)
            store_freed = unique_before - self.master.pool.dedup_cxl.unique_bytes()
            return (old_cxl - new_cxl) + store_freed
        return None

    def _demote_publish(self, name: str, image: StateImage, old_version: int,
                        dedup: bool = False) -> bool:
        """Drive the demoting publish with a bounded drain.  On a drain
        timeout the victim is rolled back to PUBLISHED (the update path
        tombstones before freeing; until the drain completes the old
        regions are untouched, so flipping the state back simply restores
        borrowability) — a timed-out demotion must never wedge the victim
        as a permanent TOMBSTONE."""
        gen = self.master.publish_steps(name, image, [],
                                        metadata={"demoted_from": old_version},
                                        expect_version=old_version,
                                        dedup=dedup)
        clock = self.master.clock
        deadline: Optional[float] = None
        entry: Optional[CatalogEntry] = None
        for label, value in gen:
            if label == "tombstoned":
                entry = value
            elif label == "done":
                return True
            elif label == "stale":
                return False      # an owner update raced us: not our victim
            if label in ("draining", "owner_busy"):
                if deadline is None:
                    deadline = clock.monotonic() + self.demote_drain_timeout_s
                if clock.monotonic() > deadline:
                    gen.close()
                    if (label == "draining" and entry is not None
                            and entry.regions is not None):
                        entry.state.compare_exchange(STATE_TOMBSTONE,
                                                     STATE_PUBLISHED)
                    return False
                clock.sleep(1e-5)
        return False

    def report(self) -> Dict[str, int]:
        self.usage()
        return self.budget.report()


class PoolMaster:
    """Ownership-protocol control plane for one pod's snapshot catalog."""

    def __init__(self, pool: HierarchicalPool, catalog: Optional[Catalog] = None,
                 clock: Optional[Clock] = None, cxl_budget: Optional[int] = None,
                 heat=None, dedup: bool = False, publish_fn=None):
        self.pool = pool
        # default fused publish sweep (kernels/snapshot_fuse): used by every
        # publish this master drives — including re-curation rebuilds and
        # capacity demotions — unless the call site overrides it
        self.publish_fn = publish_fn
        self.clock = clock or getattr(pool, "clock", None) or REAL_CLOCK
        self.catalog = catalog or Catalog(clock=self.clock)
        # per-pod CXL capacity manager (None ⇒ unmanaged, paper behaviour)
        self.capacity = (CXLCapacityManager(self, cxl_budget)
                         if cxl_budget is not None else None)
        # pod-level HeatRegistry (online feedback); recurate() reads it
        self.heat = heat
        # default publish mode: content-addressed page store (per-publish
        # ``dedup=`` overrides; updates/demotions/re-curations preserve the
        # existing snapshot's mode so a pod can mix layouts)
        self.dedup_default = dedup
        self._versions: Dict[str, int] = {}
        self._pending_reclaim: List[CatalogEntry] = []
        self._lock = threading.Lock()
        # Owner-op serialization (two concurrent tombstone→free→republish
        # sequences of one snapshot would double-free the old regions; two
        # concurrent first publishes of one name would leak an entry):
        #   _busy_names  — names with a publish in flight (claimed first)
        #   _owner_busy  — entry indices mid-update; gc() defers these
        self._busy_names: set = set()
        self._owner_busy: set = set()

    # -- snapshot lifecycle (§3.3 Owner protocol) -------------------------------
    def publish_steps(
        self,
        name: str,
        image: StateImage,
        working_set: Sequence[int],
        metadata: Optional[dict] = None,
        zero_bitmap: Optional[np.ndarray] = None,
        gather_fn=None,
        compress_cold: bool = False,
        expect_version: Optional[int] = None,
        dedup: Optional[bool] = None,
        publish_fn=None,
        version: Optional[int] = None,
    ) -> Iterator[Tuple[str, object]]:
        """Generator form of :meth:`publish`, yielding at the owner protocol's
        phase boundaries so the deterministic simulator can interleave
        borrowers (and crash the owner) *between* phases.  Yields
        ``(label, value)``:

        * ``("owner_busy", name)``     — another publish of this name is in
          flight; the driver waits (sleep / timeout) and resumes to re-poll;
        * ``("stale", entry)``         — terminal: ``expect_version`` was
          given and the entry's version moved before we claimed the name
          (used by re-curation, which republishes *reconstructed* bytes and
          must never overwrite a newer legitimate update with them);
        * ``("built_new", regions)``   — new-name path, data written;
        * ``("tombstoned", entry)``    — update path, new borrows now fail;
        * ``("draining", entry)``      — refcount still nonzero; the driver
          decides how to wait (sleep / timeout) and resumes to re-poll;
        * ``("freed_old", entry)``     — old data regions returned to the pool;
        * ``("rebuilt", regions)``     — new data written, not yet visible;
        * ``("done", regions)``        — terminal: snapshot is PUBLISHED.
        """
        dedup = self.dedup_default if dedup is None else bool(dedup)
        publish_fn = self.publish_fn if publish_fn is None else publish_fn
        # claim the name BEFORE assigning a version or inspecting the catalog:
        # serialized publishes then get monotonic versions and concurrent
        # first-publishes of a new name cannot both take the create path
        while True:
            with self._lock:
                if name not in self._busy_names:
                    self._busy_names.add(name)
                    break
            yield ("owner_busy", name)
        existing = None
        try:
            existing = self.catalog.find(name)
            if expect_version is not None and (
                    existing is None or existing.version != expect_version):
                yield ("stale", existing)
                return
            with self._lock:
                # ``version``: a group-level replica manager (topology layer)
                # assigns ONE version for a (name, version) replicated across
                # pods, overriding this master's private counter — replicas
                # of a snapshot must agree on version, not just bytes (I7)
                if version is None:
                    version = self._versions.get(name, -1) + 1
                self._versions[name] = max(self._versions.get(name, -1),
                                           version)
            if existing is None:
                regions = self._build_admitted(
                    name, image, working_set,
                    version=version, metadata=metadata,
                    zero_bitmap=zero_bitmap, gather_fn=gather_fn,
                    compress_cold=compress_cold, dedup=dedup,
                    publish_fn=publish_fn,
                )
                yield ("built_new", regions)
                self.catalog.publish_new(name, regions, version)
                if self.heat is not None:
                    self.heat.prune(name, version - 1)
                yield ("done", regions)
                return
            # Update (§3.3): tombstone → wait for borrows to drain → rewrite
            # the data regions → republish.  Freeing before rebuilding lets
            # first-fit reuse the same pool addresses (the paper writes in
            # place), which is exactly why borrowers must clflushopt after a
            # successful borrow.
            old = existing.regions
            # A pending delete of this name is superseded by the update:
            # cancel its deferred reclaim BEFORE tombstoning (gc() skips
            # PUBLISHED entries), else a concurrent gc() during our drain
            # window would free the old regions a second time and reclaim
            # the entry mid-update.  Deletes issued *during* the drain are
            # handled by gc() deferring entries in _owner_busy.
            with self._lock:
                while existing in self._pending_reclaim:
                    self._pending_reclaim.remove(existing)
                self._owner_busy.add(existing.index)
            self.catalog.tombstone(name)
            yield ("tombstoned", existing)
            while existing.refcount.load() != 0:
                yield ("draining", existing)
            if old is not None:
                free_snapshot(self.pool, old)
                # drop the dangling reference NOW: if we crash (generator
                # close) or the rebuild raises before republish, a later
                # delete()+gc() must not free these bytes a second time
                existing.regions = None
            yield ("freed_old", existing)
            regions = self._build_admitted(
                name, image, working_set,
                version=version, metadata=metadata,
                zero_bitmap=zero_bitmap, gather_fn=gather_fn,
                compress_cold=compress_cold, dedup=dedup,
                publish_fn=publish_fn,
            )
            yield ("rebuilt", regions)
            self.catalog.republish(existing, regions, version)
            if self.heat is not None:
                self.heat.prune(name, version - 1)
            # a delete() that landed during our drain window is superseded by
            # this update (last writer wins): clear its pending reclaim, else
            # the now-PUBLISHED entry sits in _pending_reclaim forever
            with self._lock:
                while existing in self._pending_reclaim:
                    self._pending_reclaim.remove(existing)
        finally:
            # also runs on generator close (aborted/crashed owner), so a dead
            # update never wedges later publishes of the same name
            with self._lock:
                self._busy_names.discard(name)
                if existing is not None:
                    self._owner_busy.discard(existing.index)
        yield ("done", regions)

    def publish(
        self,
        name: str,
        image: StateImage,
        working_set: Sequence[int],
        metadata: Optional[dict] = None,
        zero_bitmap: Optional[np.ndarray] = None,
        gather_fn=None,
        compress_cold: bool = False,
        drain_timeout_s: float = 30.0,
        dedup: Optional[bool] = None,
        publish_fn=None,
        version: Optional[int] = None,
    ) -> SnapshotRegions:
        """Blocking driver over :meth:`publish_steps` (production path)."""
        regions = self._drive_steps(
            self.publish_steps(name, image, working_set, metadata=metadata,
                               zero_bitmap=zero_bitmap, gather_fn=gather_fn,
                               compress_cold=compress_cold, dedup=dedup,
                               publish_fn=publish_fn, version=version),
            name, drain_timeout_s)
        assert regions is not None
        return regions

    def _drive_steps(self, gen: Iterator[Tuple[str, object]], name: str,
                     drain_timeout_s: float) -> Optional[SnapshotRegions]:
        """Shared blocking driver for the owner-op step generators: poll
        through draining/owner_busy with one overall drain deadline, return
        the regions on ``done`` or None on ``skipped``/``missing``."""
        deadline: Optional[float] = None
        regions: Optional[SnapshotRegions] = None
        for label, value in gen:
            if label in ("draining", "owner_busy"):
                if deadline is None:
                    deadline = self.clock.monotonic() + drain_timeout_s
                if self.clock.monotonic() > deadline:
                    raise TimeoutError(f"borrows of {name} did not drain")
                self.clock.sleep(1e-5)
            elif label == "done":
                regions = value
            elif label in ("skipped", "missing", "stale"):
                return None
        return regions

    def _build_admitted(self, name: str, image: StateImage,
                        working_set: Sequence[int], **build_kw) -> SnapshotRegions:
        """Build one snapshot under the pod CXL budget: ask the capacity
        manager to admit the estimated CXL bytes (demoting clock victims if
        needed), and degrade the hot set to RDMA (empty working set) when it
        cannot — or when first-fit fragmentation still fails the alloc.
        Over-subscribed pods degrade; they do not raise ``AllocError``."""
        ws = working_set
        if self.capacity is not None and len(ws):
            need = estimate_snapshot_cxl_size(
                image, ws, build_kw.get("zero_bitmap"),
                metadata=build_kw.get("metadata"),
                compress_cold=build_kw.get("compress_cold", False),
                dedup=build_kw.get("dedup", False), pool=self.pool)
            if not self.capacity.admit(need, exclude_name=name):
                ws = []
        try:
            return build_snapshot(self.pool, image, ws, name, **build_kw)
        except AllocError as e:
            # degrade only on a CXL-side failure: an all-cold rebuild needs
            # strictly MORE RDMA bytes, so retrying an RDMA failure is
            # guaranteed to fail again (and in the update path would leave
            # the entry wedged with its old regions already freed)
            if (self.capacity is None or not len(ws)
                    or getattr(e, "tier", "") != "cxl"):
                raise
            self.capacity.budget.stats["degraded"] += 1
            return build_snapshot(self.pool, image, [], name, **build_kw)

    # -- online re-curation (heat feedback → snapshot rebuild) -----------------
    def recurate_steps(self, name: str, heat=None, **_kw) -> Iterator[Tuple[str, object]]:
        """Generator form of :meth:`recurate` (reference
        ``PoolMaster.recurate_steps``): a re-curation plan and its
        break-even economics republished through :meth:`publish_steps`."""
        raise NotImplementedError(_RECURATE_TODO)

    def recurate(self, name: str, heat=None, drain_timeout_s: float = 30.0,
                 **kw) -> Optional[SnapshotRegions]:
        """Blocking driver over :meth:`recurate_steps`."""
        return self._drive_steps(self.recurate_steps(name, heat=heat, **kw),
                                 name, drain_timeout_s)

    def delete(self, name: str, gc_now: bool = True) -> bool:
        """Tombstone + schedule reclaim.  ``gc_now=False`` defers the reclaim
        to an explicit :meth:`gc` call (the simulator interleaves other hosts
        — and lease expiry — between the tombstone and the reclaim).

        Owner ops are last-writer-wins: a delete that lands while an update
        of the same name is draining is superseded by the update (the entry
        is republished and the pending reclaim cancelled)."""
        entry = self.catalog.tombstone(name)
        if entry is None:
            return False
        with self._lock:
            if entry not in self._pending_reclaim:
                self._pending_reclaim.append(entry)
        if gc_now:
            self.gc()
        return True

    def gc(self) -> int:
        """Reclaim tombstoned entries whose refcount has drained (§3.3)."""
        freed = 0
        with self._lock:
            remaining: List[CatalogEntry] = []
            for entry in self._pending_reclaim:
                if entry.index in self._owner_busy:
                    # an update owns this entry's transition (its drain window
                    # is transiently TOMBSTONE/refcount==0): reclaiming now
                    # would double-free the old regions under the updater
                    remaining.append(entry)
                    continue
                if entry.refcount.load() == 0 and entry.state.load() == STATE_TOMBSTONE:
                    # free what the entry holds NOW (a delete-time copy could
                    # be stale if an update swapped the regions in between)
                    if entry.regions is not None:
                        free_snapshot(self.pool, entry.regions)
                    self.catalog.reclaim(entry)
                    freed += 1
                else:
                    remaining.append(entry)
            self._pending_reclaim = remaining
        return freed

    # -- §3.6 CXL pool eviction ---------------------------------------------------
    def collect_borrow_counters(self) -> Dict[str, int]:
        """Periodic collection; resets counters to build the ranked candidate
        list (temporal locality = recency of this window, frequency = count)."""
        out: Dict[str, int] = {}
        for entry in self.catalog.entries:
            if entry.regions is not None and entry.name:
                out[entry.name] = entry.borrow_counter.exchange(0)
        return out

    def evict_for(self, needed_bytes: int) -> List[str]:
        """Delete lowest-ranked snapshots until `needed_bytes` of CXL frees.

        Dedup snapshots are scored by their EXCLUSIVE footprint (metadata +
        pages no other live snapshot references): deleting a mostly-shared
        victim reclaims only its private region, and the ranking must not
        credit it with bytes its co-owners keep alive."""
        counters = self.collect_borrow_counters()
        ranked = sorted(counters.items(), key=lambda kv: kv[1])
        evicted: List[str] = []
        freed = 0
        for name, _count in ranked:
            if freed >= needed_bytes:
                break
            entry = self.catalog.find(name)
            if entry is None or entry.regions is None:
                continue
            r = entry.regions
            if r.dedup:
                # pin while decoding the stored offset array (same rule as
                # the capacity sweep: never read regions bytes unpinned)
                pin = self.catalog.borrow(name)
                if pin is not None and pin.regions is r:
                    try:
                        freed += r.cxl_size + exclusive_cxl_bytes(self.pool, r)
                    finally:
                        pin.release()
                else:
                    if pin is not None:
                        pin.release()
                    freed += r.cxl_size
            else:
                freed += r.cxl_size
            self.delete(name)
            evicted.append(name)
        return evicted

    # -- introspection ---------------------------------------------------------
    def capacity_report(self) -> Dict[str, int]:
        return {
            "cxl_in_use": self.pool.cxl.bytes_in_use,
            "cxl_capacity": self.pool.cxl.capacity,
            "rdma_in_use": self.pool.rdma.bytes_in_use,
            "rdma_capacity": self.pool.rdma.capacity,
        }
