"""k-replica snapshot publication across pods under the ownership protocol.

The :class:`ReplicaManager` is the cluster-level writer over a
:class:`~repro_torch.topology.pod.PodGroup`.  It adds exactly two obligations on
top of the per-pod protocol (I1–I6 unchanged inside each pod):

I7  **replica coherence** — every PUBLISHED replica of a ``name`` is at
    one version, and replicas of ``(name, version)`` are bit-identical.
    Enforced by construction: the manager assigns ONE group-level version
    per write (passed to every pod master via the ``version=`` override)
    and drives the per-pod ``publish_steps`` generators in *lockstep* —
    every pod is held at its pre-republish barrier (``built_new`` /
    ``rebuilt``, i.e. after its own tombstone → drain → rebuild) before
    any pod republishes.  At no step are replicas of two different
    versions simultaneously borrowable.  Updates and deletes drain every
    replica through each pod's own tombstone/drain window.

I8  **single writer across pods** — at most one in-flight group write per
    name, tracked in ``_writers``; any pod master busy on a managed name
    without the group writer lock is a protocol bypass (the sim's
    ``check_single_writer`` catches it).

Reads are routed by :meth:`borrow_route`: home-pod CXL when an MHD port
grants, else inter-pod RDMA to the least-served reachable replica
(load-balancing), falling back to a cold start when every replica is
partitioned away or dead.  Replica demand is tracked per home pod — the
signal :class:`~repro_torch.topology.migration.MigrationManager` rebalances on.

A new replica (:meth:`ReplicaManager.add_replica_steps`) is reconstructed
from its source pod's tiers into one image-sized tensor on that pod's
device and published from there.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.snapshot import reconstruct_image
from .pod import PodGroup
from .router import InterPodRouter

#: Per-pod publish labels are namespaced ``pod<i>:<label>``.
def split_pod_label(label: str) -> Tuple[Optional[int], str]:
    """``"pod3:draining"`` → ``(3, "draining")``; plain labels → ``(None,
    label)`` — the sim wrapper's parse of namespaced generator yields."""
    if label.startswith("pod") and ":" in label:
        head, base = label.split(":", 1)
        try:
            return int(head[3:]), base
        except ValueError:
            return None, label
    return None, label


class ReplicaManager:
    """Cluster-level replicated writes + routed reads over a pod group."""

    def __init__(self, group: PodGroup, router: Optional[InterPodRouter] = None):
        self.group = group
        self.router = router or InterPodRouter(group)
        self._lock = threading.Lock()
        self._writers: Dict[str, object] = {}      # name -> writer token (I8)
        self._versions: Dict[str, int] = {}        # group-level version counter
        self._replicas: Dict[str, Dict[int, int]] = {}   # name -> {pod: version}
        self._working_sets: Dict[str, List[int]] = {}
        self.demand: Dict[str, Dict[int, int]] = {}      # name -> {home_pod: n}
        self.served: Dict[str, Dict[int, int]] = {}      # name -> {pod: reads}
        self.stats = {"group_publishes": 0, "group_deletes": 0,
                      "replicas_added": 0, "replicas_dropped": 0,
                      "port_fallthrough": 0, "promotions": 0,
                      "routed_local": 0, "routed_interpod": 0,
                      "routed_none": 0}

    # -- introspection (the I7/I8 checkers read these) ---------------------
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def replica_pods(self, name: str) -> List[int]:
        with self._lock:
            return sorted(self._replicas.get(name, {}))

    def version_of(self, name: str) -> Optional[int]:
        with self._lock:
            v = self._versions.get(name)
        return v

    def holds_writer(self, name: str) -> bool:
        with self._lock:
            return name in self._writers

    # -- the group writer lock (I8) ----------------------------------------
    def _claim_writer(self, name: str) -> Iterator[Tuple[str, str]]:
        """Spin for the group writer lock, yielding ``("group_busy",
        name)`` per failed poll; returns the token via StopIteration."""
        token = object()
        while True:
            with self._lock:
                if name not in self._writers:
                    self._writers[name] = token
                    return token
            yield ("group_busy", name)

    def _release_writer(self, name: str, token: object) -> None:
        with self._lock:
            if self._writers.get(name) is token:
                del self._writers[name]

    # -- replicated publish / update (I7 lockstep) -------------------------
    def publish_steps(self, name: str, image, working_set: Sequence[int],
                      pods: Optional[Sequence[int]] = None,
                      dedup: Optional[bool] = None,
                      **kw) -> Iterator[Tuple[str, object]]:
        """Publish (or update) ``name`` on every target pod at ONE group
        version, yielding each pod's protocol phases as ``pod<i>:<label>``.

        Phase A drives every pod to its pre-republish barrier — for an
        update that means the pod has tombstoned, drained ITS replica's
        borrows, freed the old bytes, and rebuilt; yields ``("barrier",
        version)`` once all pods are held there.  Phase B then republishes
        pod by pod.  Because every replica tombstones before any
        republishes, the set of PUBLISHED replica versions is always a
        subset of {old} before the barrier and {new} after it — never
        mixed (I7).  Terminal: ``("done", {pod: regions})``.
        """
        token = yield from self._claim_writer(name)
        held = []
        try:
            with self._lock:
                targets = (sorted(pods) if pods is not None
                           else sorted(self._replicas.get(name, {})) or [0])
                version = self._versions.get(name, -1) + 1
                self._versions[name] = version
                self._working_sets[name] = list(working_set)
            for pid in targets:
                gen = self.group.pod(pid).master.publish_steps(
                    name, image, working_set, version=version, dedup=dedup,
                    **kw)
                held.append((pid, gen))
                for label, val in gen:
                    yield (f"pod{pid}:{label}", val)
                    if label in ("built_new", "rebuilt"):
                        break
            yield ("barrier", version)
            done: Dict[int, object] = {}
            for pid, gen in held:
                for label, val in gen:
                    yield (f"pod{pid}:{label}", val)
                    if label == "done":
                        done[pid] = val
            with self._lock:
                self._replicas[name] = {pid: version for pid in done}
                self.stats["group_publishes"] += 1
        finally:
            self._release_writer(name, token)
            # a closed group write (an aborted or crashed writer) ends every
            # pod's owner protocol at this step: each releases its name
            for _pid, gen in held:
                gen.close()
        yield ("done", done)

    # -- replicated delete (drains every replica) --------------------------
    def delete_steps(self, name: str,
                     gc_polls: int = 64) -> Iterator[Tuple[str, object]]:
        """Tombstone every replica first (no new borrows anywhere), then
        drain/GC each pod; yields ``pod<i>:gc_pending`` while a replica's
        borrows are still live.  Terminal: ``("done", name)``."""
        token = yield from self._claim_writer(name)
        try:
            with self._lock:
                targets = sorted(self._replicas.get(name, {}))
            if not targets:
                yield ("missing", name)
                return
            for pid in targets:
                m = self.group.pod(pid).master
                if m.delete(name, gc_now=False):
                    yield (f"pod{pid}:tombstoned", name)
                else:
                    yield (f"pod{pid}:missing", name)
            for pid in targets:
                m = self.group.pod(pid).master
                for _ in range(gc_polls):
                    if m.gc() or not m._pending_reclaim:
                        break
                    yield (f"pod{pid}:gc_pending", name)
                yield (f"pod{pid}:gc_done", name)
            with self._lock:
                self._replicas.pop(name, None)
                self.demand.pop(name, None)
                self.served.pop(name, None)
                self.stats["group_deletes"] += 1
        finally:
            self._release_writer(name, token)
        yield ("done", name)

    # -- replica-set changes (migration, promotion repair) -----------------
    def add_replica_steps(self, name: str, dst_pod: int,
                          dedup: Optional[bool] = None) -> Iterator[Tuple[str, object]]:
        """Materialize one more replica of ``name`` on ``dst_pod`` at the
        CURRENT group version: reconstruct the image from a reachable
        source replica (pinned while read), then publish it on the target
        pod with the ``version=`` override — same version, bit-identical
        bytes, so I7 holds through the whole step.  Terminal on success:
        ``("done", (name, dst_pod))``."""
        token = yield from self._claim_writer(name)
        try:
            with self._lock:
                reps = dict(self._replicas.get(name, {}))
            if not reps:
                yield ("missing", name)
                return
            if dst_pod in reps:
                yield ("already", dst_pod)
                return
            src = None
            for pid in sorted(reps):
                if self.group.pod(pid).alive and self.group.link_up(dst_pod, pid):
                    src = pid
                    break
            if src is None:
                yield ("unreachable", name)
                return
            pod = self.group.pod(src)
            pin = pod.catalog.borrow(name)
            if pin is None or pin.regions is None:
                if pin is not None:
                    pin.release()
                yield ("missing", name)
                return
            try:
                version = pin.version
                image = reconstruct_image(pod.pool, pin.regions)
            finally:
                pin.release()
            yield ("reconstructed", (src, version))
            gen = self.group.pod(dst_pod).master.publish_steps(
                name, image, self._working_sets.get(name, []),
                version=version, dedup=dedup)
            with contextlib.closing(gen):
                for label, val in gen:
                    yield (f"pod{dst_pod}:{label}", val)
            with self._lock:
                self._replicas.setdefault(name, {})[dst_pod] = version
                self.stats["replicas_added"] += 1
        finally:
            self._release_writer(name, token)
        yield ("done", (name, dst_pod))

    def drop_replica_steps(self, name: str, pod_id: int,
                           gc_polls: int = 64) -> Iterator[Tuple[str, object]]:
        """Retire one replica (never the last copy): tombstone + drain that
        pod's borrows, then GC.  Terminal: ``("done", (name, pod_id))``."""
        token = yield from self._claim_writer(name)
        try:
            with self._lock:
                reps = self._replicas.get(name, {})
                if pod_id not in reps:
                    yield ("missing", pod_id)
                    return
                if len(reps) <= 1:
                    yield ("last_replica", pod_id)
                    return
            m = self.group.pod(pod_id).master
            if m.delete(name, gc_now=False):
                yield (f"pod{pod_id}:tombstoned", name)
            for _ in range(gc_polls):
                if m.gc() or not m._pending_reclaim:
                    break
                yield (f"pod{pod_id}:gc_pending", name)
            with self._lock:
                self._replicas.get(name, {}).pop(pod_id, None)
                self.served.get(name, {}).pop(pod_id, None)
                self.stats["replicas_dropped"] += 1
        finally:
            self._release_writer(name, token)
        yield ("done", (name, pod_id))

    # -- read routing ------------------------------------------------------
    def note_demand(self, name: str, home_pod: int) -> None:
        with self._lock:
            d = self.demand.setdefault(name, {})
            d[home_pod] = d.get(home_pod, 0) + 1

    def borrow_route(self, host: str,
                     name: str) -> Optional[Tuple[str, int]]:
        """Pick the replica pod serving ``host``'s next borrow of ``name``.

        Returns ``("cxl", pod)`` with an MHD port HELD (caller must
        ``group.pod(pod).ports.detach(host)`` after release) when the home
        pod has a live replica and a port grants; ``("interpod", pod)``
        for the least-served reachable replica otherwise (exhausted ports
        fall through to the fabric — including to the home pod itself);
        None when every replica is partitioned away or dead (cold start).
        """
        home = self.group.home_pod(host)
        self.note_demand(name, home)
        with self._lock:
            reps = sorted(self._replicas.get(name, {}))
        reps = [p for p in reps if self.group.pod(p).alive]
        if not reps:
            self.stats["routed_none"] += 1
            return None
        if home in reps:
            pod = self.group.pod(home)
            if pod.ports.try_attach(host):
                self._note_served(name, home)
                self.stats["routed_local"] += 1
                return ("cxl", home)
            pod.ports.note_fallthrough()
            self.stats["port_fallthrough"] += 1
        reachable = [p for p in reps if self.group.link_up(home, p)]
        if not reachable:
            self.stats["routed_none"] += 1
            return None
        with self._lock:
            served = self.served.setdefault(name, {})
            pick = min(reachable, key=lambda p: (served.get(p, 0), p))
        self._note_served(name, pick)
        self.stats["routed_interpod"] += 1
        return ("interpod", pick)

    def _note_served(self, name: str, pod_id: int) -> None:
        with self._lock:
            served = self.served.setdefault(name, {})
            served[pod_id] = served.get(pod_id, 0) + 1

    # -- pod loss ----------------------------------------------------------
    def promote(self, dead_pod: int) -> List[str]:
        """Owner-pod loss: mark the pod dead and promote survivors — every
        replica set simply drops the dead pod (surviving replicas are
        already PUBLISHED at the group version, so promotion is a routing
        change, not a data copy).  Returns names that lost their LAST
        replica (restorable only from a fresh publish)."""
        self.group.mark_dead(dead_pod)
        lost: List[str] = []
        with self._lock:
            for name, reps in self._replicas.items():
                if dead_pod in reps:
                    reps.pop(dead_pod)
                    self.stats["promotions"] += 1
                    if not reps:
                        lost.append(name)
            for name in lost:
                del self._replicas[name]
        return lost
