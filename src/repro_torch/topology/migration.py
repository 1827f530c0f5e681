"""Break-even-gated migration of warm snapshots toward demand.

Copying a snapshot to the pod where its readers live trades a one-time
inter-pod bulk copy (hot + cold bytes over the fabric, plus the rebuild
on the destination) against a per-read saving (local CXL chunks instead
of inter-pod reads).  :func:`repro_torch.serve.strategies.migration_economics`
prices that trade; :class:`MigrationManager` consults it and only
migrates past break-even — a snapshot with too few expected reads stays
where it is (``skipped_uneconomic``).

A migration is an :meth:`~repro_torch.topology.replication.ReplicaManager.
add_replica_steps` at the CURRENT group version (reconstructed bytes, so
I7 bit-identity holds throughout), optionally followed by retiring the
least-demanded source replica — "migrate" degenerates to "replicate"
when the source stays.  A migration that is closed mid-way (a crashed
mover) closes the replica step it was in, so the group writer lock is
released at that step.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

from ..core.pagestore import PAGE_SIZE
from ..serve.strategies import migration_economics
from .replication import ReplicaManager


class MigrationManager:
    """Economics-gated replica placement toward observed demand."""

    def __init__(self, manager: ReplicaManager):
        self.manager = manager
        self.stats = {"considered": 0, "migrated": 0,
                      "skipped_uneconomic": 0, "skipped_no_source": 0,
                      "dropped": 0}

    def economics_for(self, name: str, expected_reads: int,
                      conc: int = 1) -> Optional[Dict[str, float]]:
        """Price migrating ``name`` from byte counts of a live replica;
        None when no replica's regions are readable."""
        for pid in self.manager.replica_pods(name):
            pod = self.manager.group.pod(pid)
            if not pod.alive:
                continue
            entry = pod.catalog.find(name)
            if entry is None or entry.regions is None:
                continue
            r = entry.regions
            return migration_economics(int(r.hot_bytes),
                                       int(r.n_cold) * PAGE_SIZE,
                                       expected_reads, conc)
        return None

    def migrate_steps(self, name: str, dst_pod: int, expected_reads: int,
                      conc: int = 1,
                      drop_source: bool = False) -> Iterator[Tuple[str, object]]:
        """One gated migration: yields ``("economics", econ)`` then either
        ``("skipped", econ)`` (below break-even) or the full
        ``add_replica_steps`` sequence; ``drop_source=True`` then retires
        the least-demanded OTHER replica (a move rather than a copy).
        Terminal on success: ``("migrated", (name, dst_pod))``."""
        self.stats["considered"] += 1
        econ = self.economics_for(name, expected_reads, conc)
        if econ is None:
            self.stats["skipped_no_source"] += 1
            yield ("skipped", None)
            return
        yield ("economics", econ)
        if not econ["worthwhile"]:
            self.stats["skipped_uneconomic"] += 1
            yield ("skipped", econ)
            return
        ok = False
        with contextlib.closing(self.manager.add_replica_steps(name, dst_pod)) as steps:
            for label, val in steps:
                yield (label, val)
                if label == "done":
                    ok = True
        if not ok:
            self.stats["skipped_no_source"] += 1
            return
        self.stats["migrated"] += 1
        if drop_source:
            victim = self._least_demanded(name, exclude=dst_pod)
            if victim is not None:
                with contextlib.closing(self.manager.drop_replica_steps(name, victim)) as steps:
                    for label, val in steps:
                        yield (label, val)
                self.stats["dropped"] += 1
        yield ("migrated", (name, dst_pod))

    def _least_demanded(self, name: str,
                        exclude: int) -> Optional[int]:
        """The replica pod serving the fewest routed reads (ties break on
        lowest pod id), never the one just added."""
        pods = [p for p in self.manager.replica_pods(name) if p != exclude]
        if not pods:
            return None
        served = self.manager.served.get(name, {})
        return min(pods, key=lambda p: (served.get(p, 0), p))
