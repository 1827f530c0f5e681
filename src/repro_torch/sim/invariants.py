"""Coherence/pool invariants, checked after every simulator step.

The checker reads the *actual* shared state (catalog entries, lease words,
tier free lists) and compares it against the cluster's independent
accounting of what every host program has done.  Violations raise
:class:`InvariantViolation` tagged with the scenario seed and step number,
so any failure reproduces exactly by re-running the scenario with that seed.

Invariant list (DESIGN.md §9):

  I1  refcount accounting — every entry's refcount equals the number of
      live (successful, unreleased) borrows plus in-flight increments of
      borrows paused between their refcount++ and state CAS.  Orphans from
      crashed hosts stay counted: a crash may leak a refcount, but the
      shared word must never drift from the sum of causes.
  I2  single master per term — a lease term is never observed with two
      different holders, and at most one node is ``is_master`` at any step.
  I3  pool conservation — per tier: bytes_in_use + free bytes == capacity,
      with a sorted, non-overlapping, in-bounds free list.
  I4  borrow pinning — a live successful borrow's entry still points at the
      regions/version observed at borrow time (owner updates must drain
      first); borrowers therefore never observe TOMBSTONE'd data bytes.
  I5  catalog sanity — PUBLISHED entries have regions; refcounts are
      non-negative; states are in the valid set.
  I6  dedup refcount conservation — for each content store (CXL and RDMA),
      every stored page's refcount equals the number of live offset-array
      slots pointing at it, counted over catalog entries PLUS in-flight /
      leaked builds the cluster tracks (``pending_regions``): a crashed
      owner may leak references, but the store's words must never drift
      from the sum of causes — and a page must never be freed while any
      snapshot still points at it.
  I7  replica coherence (multi-pod, DESIGN.md §16) — all PUBLISHED
      replicas of a group-managed name carry the same version and
      bit-identical reconstructed content; a group update/delete drains
      every replica, so no step ever observes PUBLISHED replicas at two
      different versions.
  I8  single writer across pods — at most one in-flight group write per
      name, and no pod-local owner mutation of a group-managed name
      happens outside the group writer lock (a busy per-pod owner for a
      managed name without the lock is a protocol bypass).

I1/I3/I5/I6 are checked per pod; a single-pod cluster degenerates to the
original checks and I7/I8 are skipped when no :class:`ReplicaManager`
exists.  Page bytes are compared on the pods' device (I7 reconstructs each
replica into an image-sized tensor there); offsets and refcounts are host
data.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.coherence import STATE_FREE, STATE_PUBLISHED, STATE_TOMBSTONE
from ..core.failover import NO_MASTER
from ..core.pool import TIER_CXL, TIER_RDMA
from ..core.snapshot import decode_dedup_offsets, reconstruct_image


class InvariantViolation(AssertionError):
    """A checked coherence/pool invariant failed at a specific (seed, step)."""


class InvariantChecker:
    """Checks I1–I8 against a SimCluster after every scheduler step."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.term_history: Dict[int, int] = {}   # lease term -> holder node id
        # I7 bit-compare cache: name -> sorted (pod, version) signature at
        # the last full reconstruct, so identical steady states skip the
        # O(bytes) comparison
        self._replica_sigs: Dict[str, Tuple[Tuple[int, int], ...]] = {}
        self.checks_run = 0

    def _fail(self, invariant: str, msg: str) -> None:
        c = self.cluster
        raise InvariantViolation(
            f"[seed={c.seed} step={c.step_no}] {invariant} violated: {msg}\n"
            f"  reproduce with SimCluster(seed={c.seed}) and the same scenario"
        )

    # -- I1 -------------------------------------------------------------------
    def check_refcounts(self) -> None:
        c = self.cluster
        for pod in c.pods:
            for entry in pod.catalog.entries:
                key = (pod.pod_id, entry.index)
                expected = c.live.get(key, 0) + c.midflight.get(key, 0)
                actual = entry.refcount.load()
                if actual != expected:
                    self._fail(
                        "I1 refcount==live_borrows+midflight",
                        f"pod {pod.pod_id} entry {entry.index} "
                        f"({entry.name!r}): refcount={actual}, "
                        f"live={c.live.get(key, 0)}, "
                        f"midflight={c.midflight.get(key, 0)}")
                if actual < 0:
                    self._fail("I5 refcount>=0",
                               f"pod {pod.pod_id} entry {entry.index}: {actual}")

    # -- I2 -------------------------------------------------------------------
    def check_single_master(self) -> None:
        c = self.cluster
        if c.lease is None:
            return
        term = c.lease.term.load()
        holder = c.lease.holder.load()
        if holder != NO_MASTER and term > 0:
            prev = self.term_history.setdefault(term, holder)
            if prev != holder:
                self._fail("I2 one master per lease term",
                           f"term {term} held by both node {prev} and node {holder}")
        masters = [n.node_id for n in c.nodes.values() if n.is_master]
        if len(masters) > 1:
            self._fail("I2 at most one active master",
                       f"simultaneous masters: {masters}")

    # -- I3 -------------------------------------------------------------------
    def check_pool_conservation(self) -> None:
        for pod in self.cluster.pods:
            for tier in (pod.pool.cxl, pod.pool.rdma):
                free = sorted(tier._free)
                free_bytes = sum(size for _off, size in free)
                if free_bytes + tier.bytes_in_use != tier.capacity:
                    self._fail("I3 pool byte conservation",
                               f"pod {pod.pod_id} tier {tier.name}: "
                               f"free={free_bytes} + in_use={tier.bytes_in_use}"
                               f" != capacity={tier.capacity}")
                prev_end = 0
                for off, size in free:
                    if off < 0 or size <= 0 or off + size > tier.capacity:
                        self._fail("I3 free segment in bounds",
                                   f"pod {pod.pod_id} tier {tier.name}: "
                                   f"segment ({off}, {size})")
                    if off < prev_end:
                        self._fail("I3 free segments disjoint",
                                   f"pod {pod.pod_id} tier {tier.name}: "
                                   f"segment ({off}, {size}) overlaps "
                                   f"previous ending at {prev_end}")
                    prev_end = off + size

    # -- I4 -------------------------------------------------------------------
    def check_borrow_pins(self) -> None:
        for rec in self.cluster.borrow_records:
            entry = rec.borrow.entry
            if entry.regions is not rec.regions:
                self._fail("I4 borrowed regions pinned",
                           f"{rec.host}'s borrow of {rec.name!r} v{rec.version}: "
                           f"entry regions were rewritten while borrowed")
            if entry.version != rec.version:
                self._fail("I4 borrowed version pinned",
                           f"{rec.host}'s borrow of {rec.name!r}: version "
                           f"{rec.version} -> {entry.version} while borrowed")

    # -- I5 -------------------------------------------------------------------
    def check_catalog_sanity(self) -> None:
        valid = (STATE_FREE, STATE_PUBLISHED, STATE_TOMBSTONE)
        for pod in self.cluster.pods:
            for entry in pod.catalog.entries:
                state = entry.state.load()
                if state not in valid:
                    self._fail("I5 valid entry state",
                               f"pod {pod.pod_id} entry {entry.index}: {state}")
                if state == STATE_PUBLISHED and entry.regions is None:
                    self._fail("I5 PUBLISHED implies regions",
                               f"pod {pod.pod_id} entry {entry.index} "
                               f"({entry.name!r}) has no regions")

    # -- I6 -------------------------------------------------------------------
    def check_dedup_refcounts(self) -> None:
        c = self.cluster
        pending_by_pod = getattr(c, "pending_by_pod", None) or {}
        for pod in c.pods:
            pool = pod.pool
            regions = [e.regions for e in pod.catalog.entries
                       if e.regions is not None and e.regions.dedup]
            regions += [r for r in pending_by_pod.get(pod.pod_id, [])
                        if r is not None and r.dedup]
            for store, tag, tier in ((pool.dedup_cxl, TIER_CXL, "cxl"),
                                     (pool.dedup_rdma, TIER_RDMA, "rdma")):
                actual = store.refcounts()
                if not actual and not regions:
                    continue
                expected: Dict[int, int] = {}
                for r in regions:
                    offs = decode_dedup_offsets(pool, r, tag)
                    uniq, counts = np.unique(offs, return_counts=True)
                    for off, k in zip(uniq, counts):
                        expected[int(off)] = expected.get(int(off), 0) + int(k)
                if expected != actual:
                    only_store = {o: rc for o, rc in actual.items()
                                  if expected.get(o) != rc}
                    only_cat = {o: rc for o, rc in expected.items()
                                if actual.get(o) != rc}
                    self._fail(
                        "I6 dedup refcount conservation",
                        f"pod {pod.pod_id} {tier} store refcounts drifted "
                        f"from live catalog offsets: store-side mismatches "
                        f"{only_store}, catalog-side mismatches {only_cat}")

    # -- I7 -------------------------------------------------------------------
    def check_replica_coherence(self) -> None:
        c = self.cluster
        mgr = getattr(c, "replicas", None)
        if mgr is None:
            return
        for name in mgr.names():
            published = []   # (pod_id, entry) observed PUBLISHED right now
            for pid in mgr.replica_pods(name):
                pod = c.pods[pid]
                if not pod.alive:
                    continue
                entry = pod.catalog.find(name)
                if entry is not None and entry.state.load() == STATE_PUBLISHED:
                    published.append((pid, entry))
            versions = {e.version for _pid, e in published}
            if len(versions) > 1:
                self._fail(
                    "I7 replica version coherence",
                    f"{name!r} PUBLISHED at mixed versions "
                    f"{sorted((pid, e.version) for pid, e in published)} — "
                    f"a group write republished before every replica drained")
            if len(published) < 2:
                self._replica_sigs.pop(name, None)
                continue
            sig = tuple(sorted((pid, e.version) for pid, e in published))
            if self._replica_sigs.get(name) == sig:
                continue   # same steady state already bit-verified
            images = [(pid, reconstruct_image(c.pods[pid].pool, e.regions))
                      for pid, e in published]
            ref_pid, ref = images[0]
            ref_pages = ref.pages_matrix()
            for pid, img in images[1:]:
                if not torch.equal(img.pages_matrix(), ref_pages):
                    self._fail(
                        "I7 replica bit identity",
                        f"{name!r} v{sig[0][1]}: pod {pid} replica bytes "
                        f"differ from pod {ref_pid}")
            self._replica_sigs[name] = sig

    # -- I8 -------------------------------------------------------------------
    def check_single_writer(self) -> None:
        c = self.cluster
        mgr = getattr(c, "replicas", None)
        if mgr is None:
            return
        managed = mgr.names()
        for pod in c.pods:
            for name in getattr(pod.master, "_busy_names", ()):
                if name in managed and not mgr.holds_writer(name):
                    self._fail(
                        "I8 single writer across pods",
                        f"pod {pod.pod_id} owner is mutating group-managed "
                        f"{name!r} without the group writer lock — a "
                        f"pod-local write bypassed the replication protocol")

    def check_all(self) -> None:
        self.check_refcounts()
        self.check_single_master()
        self.check_pool_conservation()
        self.check_borrow_pins()
        self.check_catalog_sanity()
        self.check_dedup_refcounts()
        self.check_replica_coherence()
        self.check_single_writer()
        self.checks_run += 1
