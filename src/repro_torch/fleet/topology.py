"""Pod-awareness for fleet placement: sparse CXL attach + replica maps.

Octopus (PAPERS.md) builds real fleets from many small MHD pods: each pod's
device exposes a fixed number of head ports, so only ``ports_per_pod``
hosts per pod are CXL-attached — everyone else reaches pool memory over
the RDMA fabric.  :class:`FleetTopology` captures the static shape the
placement layer needs:

* ``pod_of(host)`` — hosts stripe across pods (``host_id % n_pods``);
* ``attached(host)`` — the first ``ports_per_pod`` hosts of each pod hold
  a head port (``host_id // n_pods < ports_per_pod``); autoscaled
  late-comers are fabric-only, like burst capacity racked outside the pod;
* ``replicas`` — which pods hold each function's snapshot, produced by the
  planners below.

A restore is **local** (no surcharge) only when the host is attached AND
its pod holds a replica; otherwise the hot set crosses the inter-pod
fabric and the placement score/driver charge add
``strategies.interpod_hot_penalty_s`` — the same constants the topology
package executes against, so the fleet model and the data plane agree.

Planners (the multi-pod fleet_bench tiers):

* :func:`plan_single` — everything in pod 0 (the single-big-pod baseline);
* :func:`plan_balanced` — one replica per snapshot, byte-balanced across
  pods (multi-pod, no replication);
* :func:`plan_replicated` — balanced plus second replicas for hot
  functions, gated by ``strategies.migration_economics`` and a per-pod
  CXL budget: replication spends the SAME total budget, just on copies of
  what demand actually reads.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..core.pagestore import PAGE_SIZE
from ..serve.strategies import interpod_hot_penalty_s, migration_economics
from .arrivals import FunctionType
from .model import RestoreProfile


class FleetTopology:
    """Static pod shape + replica map the scheduler and driver consult."""

    def __init__(self, n_pods: int, ports_per_pod: int,
                 replicas: Optional[Dict[int, Set[int]]] = None):
        self.n_pods = int(n_pods)
        self.ports_per_pod = int(ports_per_pod)
        self.replicas: Dict[int, Set[int]] = {
            k: set(v) for k, v in (replicas or {}).items()}
        self._penalty: Dict[Tuple[int, int], float] = {}
        self.stats = {"local_placements": 0, "remote_placements": 0,
                      "unattached_placements": 0}

    def pod_of(self, host_id: int) -> int:
        return host_id % self.n_pods

    def attached(self, host_id: int) -> bool:
        return (host_id // self.n_pods) < self.ports_per_pod

    def is_local(self, host_id: int, fn_id: int) -> bool:
        """True when this host serves ``fn_id``'s hot set over its own
        pod's CXL: port-attached and the pod holds a replica."""
        return (self.attached(host_id)
                and self.pod_of(host_id) in self.replicas.get(fn_id, ()))

    def penalty_s(self, host_id: int, fn_id: int, n_hot_pages: int,
                  conc: int) -> float:
        """Extra modeled seconds for the hot read when it must cross the
        inter-pod fabric (memoized per (fn, conc) — the penalty depends
        only on the hot-set size and the host's concurrent groups)."""
        if n_hot_pages <= 0 or self.is_local(host_id, fn_id):
            return 0.0
        key = (fn_id, conc)
        v = self._penalty.get(key)
        if v is None:
            v = self._penalty[key] = interpod_hot_penalty_s(n_hot_pages, conc)
        return v

    def note_placement(self, host_id: int, fn_id: int) -> None:
        """Tally where a restore actually landed (driver calls this once
        per non-join restore, never per candidate scored)."""
        if self.is_local(host_id, fn_id):
            self.stats["local_placements"] += 1
        elif not self.attached(host_id):
            self.stats["unattached_placements"] += 1
        else:
            self.stats["remote_placements"] += 1


# ---------------------------------------------------------------------------
# replica planners (the fleet_bench multi-pod tiers)
# ---------------------------------------------------------------------------

def plan_single(fleet: Iterable[FunctionType]) -> Dict[int, Set[int]]:
    """Single-big-pod baseline: every snapshot lives in pod 0."""
    return {f.fn_id: {0} for f in fleet}


def plan_balanced(fleet: Iterable[FunctionType],
                  profiles: Dict[int, RestoreProfile],
                  n_pods: int) -> Tuple[Dict[int, Set[int]], List[int]]:
    """One replica per snapshot, byte-balanced: heaviest hot sets first
    onto the lightest pod (deterministic: ties break on fn then pod id).
    Returns (replica map, per-pod CXL bytes)."""
    loads = [0] * n_pods
    out: Dict[int, Set[int]] = {}
    order = sorted(fleet, key=lambda f: (-profiles[f.fn_id].hot_bytes, f.fn_id))
    for f in order:
        pid = min(range(n_pods), key=lambda p: (loads[p], p))
        out[f.fn_id] = {pid}
        loads[pid] += int(profiles[f.fn_id].hot_bytes)
    return out, loads


def plan_replicated(fleet: Iterable[FunctionType],
                    profiles: Dict[int, RestoreProfile],
                    n_pods: int, budget_bytes: int,
                    expected_reads: Dict[int, float]
                    ) -> Tuple[Dict[int, Set[int]], Dict[str, int]]:
    """Balanced placement plus economics-gated second replicas.

    Hottest functions first (by expected reads over the trace), a second
    replica is added only when ``migration_economics`` says the one-time
    copy amortizes — and only onto a pod with budget headroom, where the
    per-pod budget is ``budget_bytes / n_pods`` (equal TOTAL budget to the
    single-pod baseline; replication spends headroom, never new capacity).
    Returns (replica map, planner stats) — the stats prove the gate
    actually filtered."""
    out, loads = plan_balanced(fleet, profiles, n_pods)
    per_pod = budget_bytes // n_pods
    stats = {"replicas_added": 0, "skipped_uneconomic": 0,
             "skipped_no_budget": 0}
    order = sorted(fleet,
                   key=lambda f: (-expected_reads.get(f.fn_id, 0.0), f.fn_id))
    for f in order:
        prof = profiles[f.fn_id]
        econ = migration_economics(int(prof.hot_bytes), int(prof.cold_bytes),
                                   expected_reads.get(f.fn_id, 0.0))
        if not econ["worthwhile"]:
            stats["skipped_uneconomic"] += 1
            continue
        have = out[f.fn_id]
        cands = [p for p in range(n_pods)
                 if p not in have and loads[p] + prof.hot_bytes <= per_pod]
        if not cands:
            stats["skipped_no_budget"] += 1
            continue
        pid = min(cands, key=lambda p: (loads[p], p))
        have.add(pid)
        loads[pid] += int(prof.hot_bytes)
        stats["replicas_added"] += 1
    return out, stats


def hot_pages_of(profile: RestoreProfile) -> int:
    """The hot-set page count the fabric penalty is priced on."""
    return int(profile.hot_bytes // PAGE_SIZE)
