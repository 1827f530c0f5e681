"""Multi-pod topology: port-limited pods, replication, routing, migration.

What this package owns (DESIGN.md §16, docs/ARCHITECTURE.md):

* the **pod layer** — :class:`PodGroup` of per-pod pool/catalog/master
  triples, each with its own CXL budget and an MHD :class:`PortLimiter`
  on concurrent host attach (Octopus-style sparse pods), the pools' tier
  arenas on one torch device (``device=``, default ``"cuda"``);
* the **inter-pod data plane** — :class:`InterPodRouter` pricing remote
  reads through ``LinkArbiter`` over the ``strategies.INTER_POD_*`` cost
  model, with data-plane-only partitions (:class:`PodLinkDown`);
* the **replication layer** — :class:`ReplicaManager`, the cluster-level
  single writer (invariant I8) driving per-pod owner protocols in
  lockstep so replicas stay version- and bit-coherent (invariant I7);
* **migration** — :class:`MigrationManager`, break-even-gated replica
  movement toward demand via ``strategies.migration_economics``.

Coherence obligations: all group writes go through ``ReplicaManager``
(publishing a managed name directly on a pod master bypasses I8 and the
sim checker flags it); every replica mutation drains that pod's borrows
through the unchanged per-pod ownership protocol.
"""
from .migration import MigrationManager
from .pod import Pod, PodGroup, PortLimiter, UNLIMITED_PORTS
from .replication import ReplicaManager, split_pod_label
from .router import INTER_POD_COST, InterPodRouter, PodLinkDown

__all__ = [
    "INTER_POD_COST",
    "InterPodRouter",
    "MigrationManager",
    "Pod",
    "PodGroup",
    "PodLinkDown",
    "PortLimiter",
    "ReplicaManager",
    "UNLIMITED_PORTS",
    "split_pod_label",
]
