"""Port-limited CXL pods and the group that composes them into a cluster.

Octopus (PAPERS.md) shows real CXL pods are built from multi-headed
devices (MHDs) with a fixed number of head ports, so at most ``ports``
distinct hosts can be CXL-attached to a pod at once — fleets are
necessarily many small pods, not one big one.  Pond bounds pool reach to
small pod sizes for latency.  This module models exactly that:

* :class:`PortLimiter` — the per-pod MHD port budget on concurrent host
  attach.  Attach is refcounted per host (all of a host's sessions share
  its one physical port); a host beyond the limit queues
  (:meth:`PortLimiter.attach_steps`) or falls through to the inter-pod
  RDMA path (:meth:`PortLimiter.try_attach` returns False).
* :class:`Pod` — one pod: its own :class:`~repro_torch.core.pool.HierarchicalPool`
  (own ``CXLBudget`` via the master's capacity manager), catalog, master,
  and port limiter.
* :class:`PodGroup` — the pods plus the cluster-level wiring: host →
  home-pod assignment, pod liveness, and pairwise data-plane link state
  (``set_partition`` downs a link; the control plane — catalog atomics —
  is unaffected, matching a fabric partition that cuts bulk reads but not
  the management network).

Every pod's tier arenas live on the group's ``device``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ..core.clock import Clock, REAL_CLOCK
from ..core.coherence import Catalog
from ..core.master import PoolMaster
from ..core.pool import HierarchicalPool

#: Effectively-unlimited port count (single-pod back-compat default).
UNLIMITED_PORTS = 1 << 30


class PortLimiter:
    """Multi-headed-device port budget on concurrent host attach.

    ``try_attach`` grants a port when the host already holds one (attach is
    refcounted per host) or a head port is free; otherwise it returns False
    and the caller must either poll (``attach_steps``) or fall through to
    reaching the pod over the RDMA fabric.  ``detach`` releases one
    reference; the port frees when the host's last session detaches.
    """

    def __init__(self, ports: int = UNLIMITED_PORTS):
        self.ports = int(ports)
        self._lock = threading.Lock()
        self._attached: Dict[str, int] = {}
        self.stats = {"grants": 0, "releases": 0, "rejects": 0,
                      "fallthrough": 0, "peak": 0}

    def try_attach(self, host: str) -> bool:
        with self._lock:
            n = self._attached.get(host)
            if n is not None:
                self._attached[host] = n + 1
                self.stats["grants"] += 1
                return True
            if len(self._attached) >= self.ports:
                self.stats["rejects"] += 1
                return False
            self._attached[host] = 1
            self.stats["grants"] += 1
            self.stats["peak"] = max(self.stats["peak"], len(self._attached))
            return True

    def detach(self, host: str) -> None:
        with self._lock:
            n = self._attached.get(host, 0) - 1
            if n <= 0:
                self._attached.pop(host, None)
            else:
                self._attached[host] = n
            self.stats["releases"] += 1

    def attached(self, host: str) -> bool:
        with self._lock:
            return host in self._attached

    def in_use(self) -> int:
        with self._lock:
            return len(self._attached)

    def note_fallthrough(self) -> None:
        """Record that a rejected host fell through to the RDMA path."""
        with self._lock:
            self.stats["fallthrough"] += 1

    def attach_steps(self, host: str,
                     max_polls: Optional[int] = None) -> Iterator[Tuple[str, str]]:
        """Generator attach for simulator programs: yields ``("port_wait",
        host)`` per failed poll, terminally ``("attached", host)`` on a
        grant or ``("fallthrough", host)`` once ``max_polls`` is exhausted
        (the caller then serves over the inter-pod fabric instead)."""
        polls = 0
        while True:
            if self.try_attach(host):
                yield ("attached", host)
                return
            polls += 1
            if max_polls is not None and polls >= max_polls:
                self.note_fallthrough()
                yield ("fallthrough", host)
                return
            yield ("port_wait", host)


@dataclasses.dataclass
class Pod:
    """One pod: pool + catalog + master + MHD port limiter, with liveness."""

    pod_id: int
    pool: HierarchicalPool
    catalog: Catalog
    master: PoolMaster
    ports: PortLimiter
    alive: bool = True


class PodGroup:
    """A cluster of port-limited pods with host homing and link state.

    Every pod gets its own pool (own ``CXLBudget`` when ``cxl_budget`` is
    set — the budget is per pod, matching per-MHD capacity), catalog, and
    master under one shared clock, with its tier arenas on ``device``.
    Hosts are homed to a pod with :meth:`assign_host` (default: pod 0);
    data-plane links between pod pairs default up and can be partitioned
    independently of pod liveness.
    """

    def __init__(self, n_pods: int = 2, cxl_capacity: int = 64 << 20,
                 rdma_capacity: int = 128 << 20, catalog_capacity: int = 64,
                 ports_per_pod: Optional[int] = None,
                 cxl_budget: Optional[int] = None,
                 clock: Optional[Clock] = None, dedup: bool = False,
                 device="cuda"):
        self.clock = clock or REAL_CLOCK
        self.pods: List[Pod] = []
        for pid in range(n_pods):
            pool = HierarchicalPool(cxl_capacity, rdma_capacity,
                                    clock=self.clock, device=device)
            catalog = Catalog(catalog_capacity, clock=self.clock)
            master = PoolMaster(pool, catalog, cxl_budget=cxl_budget,
                                dedup=dedup)
            ports = PortLimiter(UNLIMITED_PORTS if ports_per_pod is None
                                else ports_per_pod)
            self.pods.append(Pod(pid, pool, catalog, master, ports))
        self._home: Dict[str, int] = {}
        self._links_down: set = set()       # frozenset({a, b}) pairs

    def __len__(self) -> int:
        return len(self.pods)

    def pod(self, pod_id: int) -> Pod:
        return self.pods[pod_id]

    def alive_pods(self) -> List[Pod]:
        return [p for p in self.pods if p.alive]

    # -- host homing -------------------------------------------------------
    def assign_host(self, host: str, pod_id: int) -> None:
        self._home[host] = pod_id

    def home_pod(self, host: str) -> int:
        return self._home.get(host, 0)

    # -- data-plane link state ---------------------------------------------
    def link_up(self, a: int, b: int) -> bool:
        """True when pod `a`'s hosts can bulk-read pod `b`'s tiers: the
        DESTINATION pod is alive and the pair's fabric link is not
        partitioned.  Only `b`'s liveness matters — losing a pod kills its
        memory, not its hosts' RNICs, so hosts homed on a dead pod still
        reach surviving pods over the fabric (a pod's hosts always reach
        their own pod's fabric when it is alive)."""
        if not self.pods[b].alive:
            return False
        return a == b or frozenset((a, b)) not in self._links_down

    def set_partition(self, a: int, b: int, up: bool = False) -> None:
        """Down (or restore, ``up=True``) the data-plane link between two
        pods.  Affects bulk reads only — catalog atomics keep working."""
        if up:
            self._links_down.discard(frozenset((a, b)))
        else:
            self._links_down.add(frozenset((a, b)))

    def mark_dead(self, pod_id: int) -> None:
        """Pod loss: the pod's catalog/pool are unreachable from every
        host; routing must promote the surviving replicas."""
        self.pods[pod_id].alive = False
