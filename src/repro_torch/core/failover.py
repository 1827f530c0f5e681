"""Pool-master failover (§3.6).

The paper: the pool master is a single point of failure but off the critical
path — orchestrators restore from published snapshots without contacting it;
"a replacement node can be elected as the new pool master and resume normal
operation", optionally automated with Raft-style heartbeats.

This module implements that: a heartbeat lease in shared (CXL) memory and a
CAS-based election among orchestrator nodes.  All durable state (catalog,
data regions) already lives in the shared pool, so the new master resumes
with zero state transfer — it only re-derives its version counters from the
catalog.

Time is injected (:mod:`repro_torch.core.clock`): under the real clock a
``FailoverNode`` runs its heartbeat in a thread; a deterministic simulator
instead calls :meth:`FailoverNode.tick` directly under a virtual clock, so
elections and lease expiries replay exactly from a seed.
"""
from __future__ import annotations

import threading
from typing import Optional

from .clock import Clock, REAL_CLOCK
from .coherence import AtomicU64, Catalog
from .master import PoolMaster
from .pool import HierarchicalPool

NO_MASTER = 0


class MasterLease:
    """Shared-memory heartbeat lease: (holder_id, last_beat_ns) words updated
    with atomics — the CXL-resident election state."""

    def __init__(self, timeout_s: float = 0.2, clock: Optional[Clock] = None):
        self.holder = AtomicU64(NO_MASTER)
        self.last_beat = AtomicU64(0)
        self.term = AtomicU64(0)
        self.timeout_s = timeout_s
        self.clock = clock or REAL_CLOCK

    def beat(self, node_id: int) -> bool:
        if self.holder.load() != node_id:
            return False
        self.last_beat.store(self.clock.monotonic_ns())
        return True

    def expired(self) -> bool:
        if self.holder.load() == NO_MASTER:
            return True
        return (self.clock.monotonic_ns() - self.last_beat.load()) > self.timeout_s * 1e9

    def try_elect(self, node_id: int) -> bool:
        """CAS-based takeover: succeed only if the lease is vacant/expired.
        The term counter disambiguates two nodes racing on an expired lease:
        only the CAS winner bumps the term."""
        current = self.holder.load()
        if current != NO_MASTER and not self.expired():
            return False
        if self.holder.compare_exchange(current, node_id):
            self.term.fetch_add(1)
            self.last_beat.store(self.clock.monotonic_ns())
            return True
        return False


class FailoverNode:
    """An orchestrator node that can assume pool-master duty."""

    def __init__(self, node_id: int, pool: HierarchicalPool, catalog: Catalog,
                 lease: MasterLease, beat_interval_s: float = 0.05,
                 clock: Optional[Clock] = None):
        assert node_id != NO_MASTER
        self.node_id = node_id
        self.pool = pool
        self.catalog = catalog
        self.lease = lease
        self.beat_interval_s = beat_interval_s
        self.clock = clock or getattr(pool, "clock", None) or REAL_CLOCK
        self.master: Optional[PoolMaster] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.events = []

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _join(self, timeout_s: float) -> None:
        """Bounded join; the loop waits on the stop event (not a bare sleep),
        so it exits within one scheduling quantum and tests never leak the
        heartbeat thread between cases."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            assert not t.is_alive(), f"node {self.node_id}: heartbeat thread leaked"
            self._thread = None

    def stop(self, timeout_s: float = 2.0) -> None:
        self._join(timeout_s)

    def crash(self, timeout_s: float = 2.0) -> None:
        """Simulated failure: heartbeats cease immediately."""
        self._join(timeout_s)
        self.master = None
        self.events.append("crashed")

    @property
    def is_master(self) -> bool:
        return self.lease.holder.load() == self.node_id and self.master is not None

    def _become_master(self) -> None:
        # All state is pool-resident: adopt the shared catalog and re-derive
        # version counters from it (zero state transfer).
        m = PoolMaster(self.pool, self.catalog)
        for entry in self.catalog.entries:
            if entry.name:
                m._versions[entry.name] = entry.version
        self.master = m
        self.events.append(f"elected(term={self.lease.term.load()})")

    def tick(self) -> None:
        """One heartbeat-loop iteration: beat if master, else try to elect.
        Called from the thread loop under the real clock, or directly by the
        deterministic simulator as one scheduled host step."""
        if self.lease.holder.load() == self.node_id:
            self.lease.beat(self.node_id)
        elif self.lease.expired():
            if self.lease.try_elect(self.node_id):
                self._become_master()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self.clock.wait_event(self._stop, self.beat_interval_s)
