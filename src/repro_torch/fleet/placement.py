"""Locality-aware invocation placement over a pod of restore hosts.

The scheduler maps each cold invocation to a host.  The ``locality`` policy
scores hosts on the three effects the serving stack actually implements:

* **fan-out affinity** — a host already restoring the same ``(name,
  version)`` snapshot lets the newcomer join the ``NodePageServer`` fan-out
  group: tier reads are shared, the joiner pays install-only cost;
* **dedup overlap** — a host holding resident instances of the same *base
  group* has the shared base chunks in its content-keyed ``HotChunkCache``,
  so the variant's CXL read shrinks by its shared-byte fraction
  (``DedupStore.probe_new_bytes`` / ``exclusive_cxl_bytes`` ground these
  fractions in the store's real offset tables — see fleet_bench);
* **link contention** — every distinct active group on a host fair-shares
  its CXL link and RNIC (`strategies._shared`), so piling unrelated groups
  onto one host slows them all.

``random`` and ``round_robin`` are the A/B baselines.  All three are
deterministic for a seed: random draws from a dedicated generator consumed
in event order, ties break on lowest host id.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from ..core.pagestore import PAGE_SIZE
from ..serve.strategies import _rdma_pages_faulted
from .arrivals import FunctionType
from .model import RestoreProfile

POLICIES = ("locality", "random", "round_robin")


@dataclasses.dataclass
class HostState:
    """Mutable per-host serving state the driver and scheduler share."""

    host_id: int
    slots: int = 64
    busy: int = 0                                    # occupied compute slots
    alive: bool = True
    # host CXL-link health, fed from the serving tier's circuit breaker
    # (``core.faults.TierHealth``): while False, restores placed here run
    # the degraded RDMA-only path, so the scheduler de-scores the host
    cxl_healthy: bool = True
    # snapshot name -> finish time of the in-flight fan-out group's shared
    # reads; while present, same-name restores join at install-only cost
    active_restores: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # base_group -> resident instance count (running, queued-warm, or warm)
    resident_groups: Dict[int, int] = dataclasses.field(default_factory=dict)
    # fn_id -> warm-instance expiry times (driver pops oldest first)
    warm: Dict[int, Deque[float]] = dataclasses.field(default_factory=dict)
    queue: Deque[int] = dataclasses.field(default_factory=deque)

    def free_slots(self) -> int:
        return max(0, self.slots - self.busy)

    def load(self) -> float:
        return (self.busy + len(self.queue)) / max(1, self.slots)

    def add_resident(self, group: int) -> None:
        self.resident_groups[group] = self.resident_groups.get(group, 0) + 1

    def drop_resident(self, group: int) -> None:
        n = self.resident_groups.get(group, 0) - 1
        if n <= 0:
            self.resident_groups.pop(group, None)
        else:
            self.resident_groups[group] = n

    def note_health(self, cxl_health) -> None:
        """Feed a ``core.faults.TierHealth`` breaker (or None) into the
        placement state; call whenever the host's breaker changes state."""
        self.cxl_healthy = cxl_health is None or not cxl_health.degraded

    def overlap_frac(self, fn: FunctionType, profile: RestoreProfile) -> float:
        """Fraction of the hot read the host's chunk cache absorbs: the
        snapshot's shared-base bytes, if any same-group instance is (or was
        kept) resident here."""
        if profile.hot_bytes <= 0:
            return 0.0
        if self.resident_groups.get(fn.base_group, 0) <= 0:
            return 0.0
        return min(1.0, profile.shared_base_bytes / profile.hot_bytes)


class PlacementScheduler:
    """Chooses a host for each cold invocation under one of POLICIES."""

    def __init__(self, policy: str, seed: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; want one of {POLICIES}")
        self.policy = policy
        # optional FleetTopology (fleet/topology.py): when set, hosts whose
        # pod lacks a replica (or that hold no MHD port) are surcharged the
        # inter-pod hot-read penalty in score() AND in the driver's charge
        self.topology = None
        self._rng = np.random.default_rng(np.random.SeedSequence((seed, 0x91ACE)))
        self._rr = 0
        self.stats = {"placed": 0, "join_hits": 0, "overlap_hits": 0}
        # restore pricing depends only on (fn, conc, overlap-or-not, join):
        # a function's overlap fraction is a constant of its snapshot, so
        # the priced cost is memoizable on a tiny key
        self._cost: Dict[tuple, float] = {}

    def priced(self, fn: FunctionType, profile: RestoreProfile,
               conc: int, ov: float, joined: bool = False) -> float:
        key = (fn.fn_id, conc, ov > 0.0, joined)
        v = self._cost.get(key)
        if v is None:
            v = profile.cold_start_s(conc, ov, joined)
            self._cost[key] = v
        return v

    def topology_penalty(self, h: HostState, fn: FunctionType,
                         profile: RestoreProfile, conc: int) -> float:
        """Fabric surcharge for a NON-join restore of ``fn`` on ``h``
        (a joiner shares the group's already-moving reads, so it never
        pays the fabric again); 0 when no topology is configured."""
        topo = self.topology
        if topo is None or profile.hot_bytes <= 0:
            return 0.0
        return topo.penalty_s(h.host_id, fn.fn_id,
                              int(profile.hot_bytes // PAGE_SIZE), conc)

    def score(self, h: HostState, fn: FunctionType,
              profile: RestoreProfile) -> float:
        """Negative modeled time-to-ready on this host, priced with the
        same RestoreProfile arithmetic the driver charges: fan-out join
        collapses to install-only, dedup overlap trims the hot read,
        distinct active groups contend for the links, and a full host
        adds a crude FIFO queue-wait.  Affinity only counts when a slot
        is free — a queued invocation starts after the group's shared
        reads (and likely the chunk residency) are gone."""
        free = h.free_slots() > 0
        if free and fn.name in h.active_restores:
            base = self.priced(fn, profile, 1, 0.0, joined=True)
        else:
            conc = len(h.active_restores) + 1
            ov = h.overlap_frac(fn, profile) if free else 0.0
            base = self.priced(fn, profile, conc, ov)
            base += self.topology_penalty(h, fn, profile, conc)
        if not h.cxl_healthy and profile.hot_bytes > 0:
            # browned-out CXL link (DESIGN.md §15): the hot set arrives
            # page-at-a-time over the RNIC instead of the chunked CXL
            # pre-install — surcharge by the repriced difference
            n_hot = int(profile.hot_bytes // PAGE_SIZE)
            base += max(0.0,
                        _rdma_pages_faulted(n_hot, 1) - profile.hot_serial_s)
        wait = 0.0 if free else (len(h.queue) + 1) * base
        return -(wait + base)

    def choose(self, hosts: List[HostState], fn: FunctionType,
               profile: RestoreProfile) -> Optional[HostState]:
        alive = [h for h in hosts if h.alive]
        if not alive:
            return None
        self.stats["placed"] += 1
        if self.policy == "random":
            pick = alive[int(self._rng.integers(len(alive)))]
        elif self.policy == "round_robin":
            pick = alive[self._rr % len(alive)]
            self._rr += 1
        else:
            best, best_score = alive[0], self.score(alive[0], fn, profile)
            for h in alive[1:]:
                s = self.score(h, fn, profile)
                if s > best_score:       # strict: ties keep lowest host_id
                    best, best_score = h, s
            pick = best
        if fn.name in pick.active_restores:
            self.stats["join_hits"] += 1
        if pick.overlap_frac(fn, profile) > 0.0:
            self.stats["overlap_hits"] += 1
        return pick
