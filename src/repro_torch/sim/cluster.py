"""Deterministic discrete-event cluster simulator.

``SimCluster`` owns one shared pod (``HierarchicalPool`` + ``Catalog`` +
``MasterLease`` under a single :class:`VirtualClock`) and N simulated hosts.
Host behaviour is expressed as **programs**: Python generators that yield a
label after every atomic step (``yield "label"``) or a simulated delay
(``yield ("sleep", seconds)``).  A seeded scheduler picks which runnable
program advances next, so:

  same seed  ⇒  same interleaving  ⇒  same trace  ⇒  same result.

Programs call the *real* production code — ``Catalog.borrow_steps``,
``PoolMaster.publish_steps``, ``FailoverNode.tick``, ``SnapshotReader``,
``Instance``/``RestoreSession`` — decomposed at protocol phase boundaries,
which is exactly where multi-host interleavings (and crashes) matter.

After every step the :class:`InvariantChecker` validates the shared state
against the cluster's independent accounting of all borrows in flight.

A program closes the protocol generator it drives when it ends — finished,
aborted or killed (a simulated crash closes the program) — so the
protocol's ``finally`` clauses (the owner's busy-name claim, the group
writer lock) run at that step, not whenever the generator is collected.

Page bytes — tier arenas, images, the canonical content every read is
verified against — live on the cluster's ``device`` (default ``"cuda"``;
pass ``device="cpu"`` for the plain kernels on the host).  The scheduler,
the traces and all accounting are host state, so one seed gives the same
trace on either device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.coherence import Borrow, Catalog
from ..core.failover import FailoverNode, MasterLease
from ..core.faults import TierFaultError
from ..core.master import PoolMaster
from ..core.pagestore import StateImage, resolve_device
from ..core.pool import HierarchicalPool
from ..core.profiler import AccessRecorder, TouchEvent
from ..core.serving import Instance, RestoreSession
from ..core.snapshot import SnapshotReader
from ..topology import (
    InterPodRouter,
    MigrationManager,
    Pod,
    PodGroup,
    PodLinkDown,
    PortLimiter,
    ReplicaManager,
    split_pod_label,
)
from .clock import VirtualClock
from .faults import FaultPlan
from .invariants import InvariantChecker, InvariantViolation


@dataclasses.dataclass
class BorrowRecord:
    """Cluster-side accounting for one successful borrow."""

    host: str
    name: str
    borrow: Borrow
    regions: object
    version: int
    pod: int = 0


@dataclasses.dataclass
class _Program:
    name: str
    gen: Iterator
    wake_at: float = 0.0
    done: bool = False
    killed: bool = False
    steps: int = 0
    last_label: str = ""


class SimCluster:
    """N-host pod over one shared catalog, driven step-by-step from a seed."""

    def __init__(
        self,
        n_hosts: int = 2,
        seed: int = 0,
        cxl_capacity: int = 64 << 20,
        rdma_capacity: int = 128 << 20,
        catalog_capacity: int = 16,
        lease_timeout_s: float = 0.2,
        beat_interval_s: float = 0.05,
        schedule: str = "random",
        step_quantum_s: float = 1e-6,
        cxl_budget: Optional[int] = None,
        n_pods: int = 1,
        ports_per_pod: Optional[int] = None,
        device="cuda",
    ):
        assert schedule in ("random", "round_robin")
        self.device = resolve_device(device)
        self.seed = seed
        self.rng = random.Random(seed)
        self.schedule = schedule
        # every step costs a small time quantum, so sleeping programs always
        # wake even while non-sleeping programs stay runnable (no starvation)
        self.step_quantum_s = step_quantum_s
        self.clock = VirtualClock()
        # topology: ``n_pods > 1`` builds a PodGroup of per-pod pool/
        # catalog/master triples plus the replication/routing layer; pod 0
        # doubles as the legacy single-pod view (self.pool/catalog/master
        # alias it) so every existing scenario runs unchanged
        if n_pods > 1:
            self.group: Optional[PodGroup] = PodGroup(
                n_pods, cxl_capacity, rdma_capacity,
                catalog_capacity=catalog_capacity,
                ports_per_pod=ports_per_pod, cxl_budget=cxl_budget,
                clock=self.clock, device=self.device)
            self.pods: List[Pod] = self.group.pods
            self.pool = self.pods[0].pool
            self.catalog = self.pods[0].catalog
            self.master = self.pods[0].master
            self.router: Optional[InterPodRouter] = InterPodRouter(self.group)
            self.replicas: Optional[ReplicaManager] = ReplicaManager(
                self.group, self.router)
            self.migrator: Optional[MigrationManager] = MigrationManager(
                self.replicas)
        else:
            self.group = None
            self.router = None
            self.replicas = None
            self.migrator = None
            self.pool = HierarchicalPool(cxl_capacity, rdma_capacity,
                                         clock=self.clock, device=self.device)
            self.catalog = Catalog(catalog_capacity, clock=self.clock)
            # the pod's initial pool master (outside the failover group);
            # cxl_budget arms the capacity manager for eviction scenarios
            self.master = PoolMaster(self.pool, self.catalog,
                                     cxl_budget=cxl_budget)
            self.pods = [Pod(0, self.pool, self.catalog, self.master,
                             PortLimiter())]
        self.lease = MasterLease(lease_timeout_s, clock=self.clock)
        # failover-capable nodes, one per host (ids 1..N; 0 is NO_MASTER)
        self.nodes: Dict[int, FailoverNode] = {
            i: FailoverNode(i, self.pool, self.catalog, self.lease,
                            beat_interval_s=beat_interval_s, clock=self.clock)
            for i in range(1, n_hosts + 1)
        }
        self._programs: Dict[str, _Program] = {}
        self._order: List[str] = []        # insertion order (round_robin)
        self._rr_next = 0
        self.step_no = 0
        self.trace: List[Tuple[int, str, str]] = []
        self.events: List[str] = []
        # borrow accounting ((pod id, entry index) -> counts); orphans from
        # crashed programs stay counted — the refcount they leaked is real.
        self.live: Dict[Tuple[int, int], int] = {}
        self.midflight: Dict[Tuple[int, int], int] = {}
        self.borrow_records: List[BorrowRecord] = []
        self.orphaned_records: List[BorrowRecord] = []
        # dedup (I6) accounting: regions built by an in-flight publish that
        # the catalog does not point at yet.  A crashed owner leaves its
        # record here forever — the references it leaked are still real.
        # ``pending_regions`` is pod 0's list (single-pod back-compat);
        # ``pending_by_pod`` holds every pod's, keyed by pod id.
        self.pending_regions: List[object] = []
        self.pending_by_pod: Dict[int, List[object]] = {0: self.pending_regions}
        for _p in self.pods[1:]:
            self.pending_by_pod[_p.pod_id] = []
        # canonical content per (name, version): the published StateImage
        self.content: Dict[str, Dict[int, StateImage]] = {}
        self.restored: List[dict] = []
        self.fault_plan = FaultPlan()
        self.checker = InvariantChecker(self)

    # ------------------------------------------------------------------
    # snapshot helpers
    # ------------------------------------------------------------------
    def make_image(self, value: float, hot_pages: int = 2, cold_pages: int = 2,
                   zero_pages: int = 1,
                   distinct_hot: bool = False) -> Tuple[StateImage, np.ndarray]:
        """A small image with hot / cold / zero page classes; 'hot' pages are
        filled with ``value`` so borrowers can verify which version they see.

        ``distinct_hot`` makes every hot page's content distinct (a function
        of ``value`` and the page rank), so two snapshots published with the
        same value share page-for-page under dedup while each snapshot's own
        pages stay unique — the fine-tuned-variant shape the dedup scenarios
        need."""
        hot = np.full(hot_pages * 1024, np.float32(value), np.float32)
        if distinct_hot:
            ranks = np.repeat(np.arange(hot_pages, dtype=np.float32), 1024)
            hot = hot + ranks * np.float32(0.125)
        arrays = {
            "hot": hot,
            "cold": np.arange(cold_pages * 1024, dtype=np.float32) + np.float32(value),
            "zeros": np.zeros(max(1, zero_pages) * 1024, np.float32),
        }
        img = StateImage.build(arrays, device=self.device)
        rec = AccessRecorder(img.manifest)
        rec.touch_array("hot")
        return img, rec.working_set()

    def publish(self, name: str, value: float, master: Optional[PoolMaster] = None,
                dedup: Optional[bool] = None, publish_fn=None,
                **image_kw) -> object:
        """Immediate (setup-time) publish through the production path.
        ``publish_fn`` passes through to ``PoolMaster.publish`` — the chaos
        scenarios use the fused publish so snapshots carry checksum tables."""
        master = master or self.master
        img, ws = self.make_image(value, **image_kw)
        regions = master.publish(name, img, ws, dedup=dedup,
                                 publish_fn=publish_fn)
        self.content.setdefault(name, {})[regions.version] = img
        self.events.append(f"published:{name}:v{regions.version}")
        return regions

    # ------------------------------------------------------------------
    # program management + the scheduler
    # ------------------------------------------------------------------
    def add_program(self, name: str, gen: Iterator) -> None:
        assert name not in self._programs, f"duplicate program {name!r}"
        self._programs[name] = _Program(name, gen)
        self._order.append(name)

    def add_heartbeat(self, node_id: int, name: Optional[str] = None) -> None:
        self.add_program(name or f"hb{node_id}",
                         self.heartbeat_program(self.nodes[node_id]))

    def kill_program(self, name: str) -> None:
        """Simulated host crash: the program never runs again.  Its live
        borrows and in-flight refcount increments leak (stay counted)."""
        prog = self._programs[name]
        if prog.done:
            return
        prog.done = prog.killed = True
        prog.gen.close()
        mine = [r for r in self.borrow_records if r.host == name]
        for r in mine:
            self.borrow_records.remove(r)
            self.orphaned_records.append(r)
            # keep self.live[...] counted: the refcount is still held
        self.events.append(f"crashed:{name}")

    def crash_node(self, node_id: int) -> None:
        """Crash a failover node: its heartbeat program dies with it."""
        hb = f"hb{node_id}"
        if hb in self._programs:
            self.kill_program(hb)
        self.nodes[node_id].crash()
        self.events.append(f"node_crashed:{node_id}")

    def _runnable(self) -> List[str]:
        now = self.clock.monotonic()
        return [n for n in self._order
                if not self._programs[n].done and self._programs[n].wake_at <= now]

    def _pick(self) -> Optional[str]:
        runnable = self._runnable()
        if not runnable:
            pending = [self._programs[n].wake_at for n in self._order
                       if not self._programs[n].done]
            if not pending:
                return None
            # discrete-event jump: advance virtual time to the next wakeup
            self.clock.advance_to(min(pending))
            runnable = self._runnable()
            assert runnable
        if self.schedule == "round_robin":
            for _ in range(len(self._order)):
                name = self._order[self._rr_next % len(self._order)]
                self._rr_next += 1
                if name in runnable:
                    return name
            return runnable[0]
        return self.rng.choice(runnable)

    def step(self) -> bool:
        """Advance one program by one step; False when nothing is left."""
        self.fault_plan.run_step_hooks(self.step_no, self)
        self.clock.advance(self.step_quantum_s)
        name = self._pick()
        if name is None:
            return False
        prog = self._programs[name]
        try:
            label = next(prog.gen)
        except StopIteration:
            prog.done = True
            label = "exit"
        if isinstance(label, tuple) and label and label[0] == "sleep":
            prog.wake_at = self.clock.monotonic() + float(label[1])
            label = f"sleep:{label[1]:g}"
        label = str(label)
        prog.steps += 1
        prog.last_label = label
        self.trace.append((self.step_no, name, label))
        if not prog.done and self.fault_plan.should_kill(name, label):
            self.kill_program(name)
        self.step_no += 1
        self.checker.check_all()
        return True

    def run(self, max_steps: int = 20000, until=None) -> List[Tuple[int, str, str]]:
        """Run until all programs finish, ``until(cluster)`` turns true, or
        the step budget is exhausted.  Returns the trace."""
        while self.step_no < max_steps:
            if until is not None and until(self):
                break
            if not self.step():
                break
        return self.trace

    # ------------------------------------------------------------------
    # tracked borrow/release (keeps the invariant accounting honest)
    # ------------------------------------------------------------------
    def borrow_program_steps(self, host: str, name: str, precheck: bool = True,
                             pod: int = 0):
        """``yield from`` this inside a host program: advances the real
        ``Catalog.borrow_steps`` one protocol phase per scheduler turn and
        maintains the cluster's refcount accounting (keyed by ``(pod,
        entry index)``).  Returns a :class:`BorrowRecord` (or None ⇒ cold
        start) via StopIteration."""
        result: Optional[BorrowRecord] = None
        catalog = self.pods[pod].catalog
        for label, val in catalog.borrow_steps(name, state_precheck=precheck):
            if label == "refcount_incremented":
                key = (pod, val.index)
                self.midflight[key] = self.midflight.get(key, 0) + 1
            elif label == "doomed":
                key = (pod, val.index)
                self.midflight[key] = self.midflight.get(key, 0) - 1
            elif label == "done" and val is not None:
                key = (pod, val.entry.index)
                self.midflight[key] = self.midflight.get(key, 0) - 1
                self.live[key] = self.live.get(key, 0) + 1
                result = BorrowRecord(host, name, val, val.regions,
                                      val.version, pod=pod)
                self.borrow_records.append(result)
            yield f"borrow:{label}"
        return result

    def release(self, rec: BorrowRecord) -> None:
        rec.borrow.release()
        self.live[(rec.pod, rec.borrow.entry.index)] -= 1
        self.borrow_records.remove(rec)

    def track_borrow(self, host: str, name: str, borrow: Optional[Borrow],
                     pod: int = 0) -> Optional[BorrowRecord]:
        """Account for a borrow acquired outside ``borrow_program_steps``
        (e.g. through ``LeaseFallback.acquire``, which is one atomic RPC)."""
        if borrow is None:
            return None
        key = (pod, borrow.entry.index)
        self.live[key] = self.live.get(key, 0) + 1
        rec = BorrowRecord(host, name, borrow, borrow.regions, borrow.version,
                           pod=pod)
        self.borrow_records.append(rec)
        return rec

    # ------------------------------------------------------------------
    # host program library
    # ------------------------------------------------------------------
    @staticmethod
    def delayed(delay_s: float, gen: Iterator):
        """Start ``gen`` only after ``delay_s`` of simulated time (scenario
        scripting: e.g. let a borrow land before the owner tombstones)."""
        yield ("sleep", delay_s)
        yield from gen

    def elected_master(self) -> Optional[PoolMaster]:
        """The PoolMaster of whichever failover node currently holds the
        lease, if any."""
        for node in self.nodes.values():
            if node.is_master:
                return node.master
        return None

    def heartbeat_program(self, node: FailoverNode):
        """The failover heartbeat loop as a schedulable program: exactly the
        body of ``FailoverNode._loop`` under the virtual clock."""
        while True:
            node.tick()
            yield "tick"
            yield ("sleep", node.beat_interval_s)

    def _drain_poll(self, name: str, gen, label: str, polls: int,
                    drain_limit: Optional[int], drain_sleep: float):
        """Shared drain/livelock guard for the publish and recurate
        programs: counts ``draining``/``owner_busy`` polls and aborts the
        protocol generator with a ``drain_timeout:<name>`` event once
        ``drain_limit`` is exhausted (the TimeoutError analogue).  Used via
        ``yield from``; returns ``(polls, aborted)``."""
        if label not in ("draining", "owner_busy"):
            return polls, False
        polls += 1
        if drain_limit is not None and polls >= drain_limit:
            self.events.append(f"drain_timeout:{name}")
            gen.close()
            return polls, True
        yield ("sleep", drain_sleep)
        return polls, False

    def publish_program(self, name: str, value: float,
                        master: Optional[PoolMaster] = None,
                        drain_limit: Optional[int] = None,
                        drain_sleep: float = 1e-5,
                        dedup: Optional[bool] = None, **image_kw):
        """Owner update through ``PoolMaster.publish_steps``, one protocol
        phase per scheduler turn.  ``drain_limit`` bounds the drain polls
        (TimeoutError analogue): on exhaustion the program records
        ``drain_timeout:<name>`` and aborts — the livelock detector.

        Built-but-unpublished regions are tracked in ``pending_regions`` for
        the I6 checker: between the build and the catalog republish (or
        forever, if the owner crashes in that window) their dedup page
        references are real but no catalog entry points at them."""
        master = master or self.master
        img, ws = self.make_image(value, **image_kw)
        polls = 0
        built = None
        gen = master.publish_steps(name, img, ws, dedup=dedup)
        with contextlib.closing(gen):
            for label, val in gen:
                if label in ("built_new", "rebuilt"):
                    built = val
                    self.pending_regions.append(val)
                elif label == "done":
                    # record canonical content BEFORE yielding: the republish has
                    # already made this version borrowable, so a borrower
                    # scheduled next turn must find it in the content table
                    if built is not None:
                        self.pending_regions.remove(built)
                        built = None
                    self.content.setdefault(name, {})[val.version] = img
                    self.events.append(f"published:{name}:v{val.version}")
                yield f"publish:{label}"
                polls, aborted = yield from self._drain_poll(
                    name, gen, label, polls, drain_limit, drain_sleep)
                if aborted:
                    return

    def delete_program(self, name: str, master: Optional[PoolMaster] = None,
                       gc_polls: int = 8, gc_sleep: float = 1e-4):
        """Owner delete: tombstone + deferred reclaim, polling gc() so the
        scheduler can interleave releases (and lease expiry) mid-GC."""
        master = master or self.master
        if not master.delete(name, gc_now=False):
            yield "delete:missing"
            return
        yield "delete:tombstoned"
        for _ in range(gc_polls):
            if master.gc() or not master._pending_reclaim:
                yield "delete:gc_done"
                return
            yield "delete:gc_pending"
            yield ("sleep", gc_sleep)
        self.events.append(f"gc_incomplete:{name}")
        yield "delete:gc_gave_up"

    def borrower_program(self, host: str, name: str, attempts: int = 4,
                         read_pages: int = 2, precheck: bool = True,
                         pause_s: float = 1e-4):
        """Borrow → clflush → read hot pages → verify against the canonical
        image for the borrowed version → release, ``attempts`` times.  A torn
        or stale read raises InvariantViolation (the I4 data-level check)."""
        successes = 0
        for i in range(attempts):
            rec = yield from self.borrow_program_steps(host, name, precheck)
            if rec is None:
                self.events.append(f"cold_start:{host}")
                yield ("sleep", pause_s)
                continue
            view = self.pool.host_view(f"{host}:a{i}")
            reader = SnapshotReader(rec.borrow.regions, view, self.pool.rdma)
            reader.invalidate_cxl()
            yield "borrower:flushed"
            canonical = self.content[name][rec.version].pages_matrix()
            for p in reader.hot_page_indices()[:read_pages]:
                got = reader.read_page(int(p))
                if not torch.equal(got, canonical[int(p)]):
                    raise InvariantViolation(
                        f"[seed={self.seed} step={self.step_no}] {host} observed "
                        f"torn/stale bytes of {name!r} v{rec.version} page {int(p)}")
                yield "borrower:read"
            self.release(rec)
            successes += 1
            yield "borrower:released"
            yield ("sleep", pause_s)
        self.events.append(f"borrower_done:{host}:{successes}/{attempts}")

    def tight_borrower_program(self, host: str, name: str, precheck: bool = True):
        """Infinite tight retry loop, one borrow attempt per scheduler turn:
        each turn finishes the previous attempt (CAS → release/back-out) and
        immediately starts the next, pausing *between* the refcount increment
        and the CAS.  Without the borrow's state pre-check this keeps the shared
        refcount permanently elevated at every owner drain poll — the
        doomed-borrow livelock."""
        pending = None
        while True:
            if pending is not None:
                rec = None
                try:
                    while True:
                        next(pending)
                except StopIteration as stop:
                    rec = stop.value
                if rec is not None:
                    self.release(rec)
            pending = self.borrow_program_steps(host, name, precheck=precheck)
            label = next(pending, None)     # pause mid-borrow if the path allows
            yield label if label is not None else "borrow:noop"

    def drift_borrower_program(self, host: str, name: str, heat_registry,
                               attempts: int = 3, cold_reads: int = 2,
                               pause_s: float = 1e-4):
        """Borrower whose working set has DRIFTED off the snapshot's frozen
        hot set: each attempt borrows, touches one hot page (keep-hot
        signal) and demand-reads ``cold_reads`` cold pages, recording both
        into the pod's :class:`~repro_torch.core.profiler.HeatRegistry` keyed by
        the borrowed version — the online-feedback signal the re-curation
        pipeline consumes.  Every cold read is verified against the
        canonical image (torn/stale bytes raise, the I4 data-level check).
        """
        for i in range(attempts):
            rec = yield from self.borrow_program_steps(host, name)
            if rec is None:
                self.events.append(f"cold_start:{host}")
                yield ("sleep", pause_s)
                continue
            view = self.pool.host_view(f"{host}:d{i}")
            reader = SnapshotReader(rec.borrow.regions, view, self.pool.rdma)
            reader.invalidate_cxl()
            yield "borrower:flushed"
            hm = heat_registry.map_for(name, rec.version,
                                       rec.borrow.regions.total_pages)
            hm.note_restore()
            # one sequence stream per restore attempt (deterministic id:
            # crc of host+attempt) — the cold reads below feed first-touch
            # transitions in demand order, not just decayed heat
            stream = zlib.crc32(f"{host}:{i}".encode())
            canonical = self.content[name][rec.version].pages_matrix()
            hot = reader.hot_page_indices()
            if hot.size:
                hm.record(TouchEvent(pages=hot[:1], kind="touch",
                                     stream=stream))
            for p in reader.cold_page_indices()[:cold_reads]:
                got = reader.read_page(int(p))
                if not torch.equal(got, canonical[int(p)]):
                    raise InvariantViolation(
                        f"[seed={self.seed} step={self.step_no}] {host} observed "
                        f"torn/stale cold bytes of {name!r} v{rec.version} "
                        f"page {int(p)}")
                hm.record(TouchEvent(pages=[int(p)], kind="demand_fault",
                                     stream=stream))
                yield "borrower:cold_read"
            self.release(rec)
            yield "borrower:released"
            yield ("sleep", pause_s)
        self.events.append(f"drift_done:{host}")

    def recurate_program(self, name: str, heat_registry,
                         master: Optional[PoolMaster] = None,
                         expected_restores: int = 64, min_restores: int = 1,
                         force: bool = False,
                         drain_limit: Optional[int] = None,
                         drain_sleep: float = 1e-5):
        """Heat-feedback re-curation through ``PoolMaster.recurate_steps``,
        one protocol phase per scheduler turn.  The rebuilt image is
        recorded as the canonical content of the new version the moment the
        republish lands, so borrowers scheduled next turn verify against
        it (re-curated restores must stay bit-identical)."""
        master = master or self.master
        entry = self.catalog.find(name)
        heat = None
        if entry is not None and entry.regions is not None:
            heat = heat_registry.find(name, entry.regions.version)
        polls = 0
        reconstructed = None
        built = None
        gen = master.recurate_steps(name, heat=heat,
                                    expected_restores=expected_restores,
                                    min_restores=min_restores, force=force)
        with contextlib.closing(gen):
            for label, val in gen:
                if label == "reconstructed":
                    reconstructed = val
                elif label in ("built_new", "rebuilt"):
                    built = val
                    self.pending_regions.append(val)
                elif label == "skipped":
                    self.events.append(f"recuration_skipped:{name}")
                elif label == "stale":
                    self.events.append(f"recuration_stale:{name}")
                elif label == "done":
                    assert reconstructed is not None
                    if built is not None:
                        self.pending_regions.remove(built)
                        built = None
                    self.content.setdefault(name, {})[val.version] = reconstructed
                    self.events.append(f"recurated:{name}:v{val.version}")
                yield f"recurate:{label}"
                polls, aborted = yield from self._drain_poll(
                    name, gen, label, polls, drain_limit, drain_sleep)
                if aborted:
                    return

    def restore_program(self, host: str, name: str, rdma=None,
                        use_batch: bool = True, max_retries: int = 6,
                        retry_backoff_s: float = 1e-4, precheck: bool = True,
                        scatter_fn=None):
        """Full warm restore via the production ``RestoreSession`` pieces
        (zeropage ranges, run-coalesced hot pre-install, cold extent reads),
        one run per scheduler turn, with SimTimeout retry/backoff on the
        (possibly flaky) RDMA tier.  Verifies the restored image is
        bit-identical to the canonical one for the borrowed version.

        ``scatter_fn`` (e.g. a ``FusedScatter``) turns on checksum
        verification against the snapshot's publish-time table, so injected
        page poison is detected at install time and repaired through the
        session's budgeted re-read path.  A CXL brownout degrades the
        restore to the RDMA-only path (``drain_degraded_hot``) instead of
        failing it; either way the bit-identity check below still runs."""
        rec = yield from self.borrow_program_steps(host, name, precheck)
        if rec is None:
            self.events.append(f"cold_start:{host}")
            return
        rdma = rdma if rdma is not None else self.pool.rdma
        view = self.pool.host_view(host)
        reader = SnapshotReader(rec.borrow.regions, view, rdma)
        reader.invalidate_cxl()
        manifest, _meta = reader.machine_state()
        inst = Instance(StateImage.empty_like(manifest, device=self.device),
                        clock=self.clock)
        session = RestoreSession(reader, inst, None, scatter_fn=scatter_fn,
                                 clock=self.clock)
        yield "restore:setup"
        inst.uffd_zeropage_runs(reader.zero_runs())
        yield "restore:zeros"
        session.pre_install_hot(use_batch=use_batch)
        yield "restore:hot"
        retries = 0
        # the extent walk handles every layout: whole guest runs for the
        # private format, dual-contiguous sub-extents for dedup snapshots
        for es, en, rank0, pool_off, nbytes in reader.iter_cold_extents(
                max_extent_pages=1 << 20):
            while True:
                try:
                    payload = rdma.read(pool_off, nbytes)
                    break
                # TierFaultError covers both seams: FlakyTier's SimTimeout
                # subclasses it, and an attached core FaultInjector raises
                # it from MemoryTier.read directly
                except TierFaultError:
                    retries += 1
                    if retries > max_retries:
                        self.release(rec)
                        raise
                    yield ("sleep", retry_backoff_s * (2 ** retries))
                    yield "restore:rdma_retry"
            session._install_verified(np.arange(es, es + en),
                                      reader.split_cold_extent(rank0, en, payload))
            yield "restore:cold_run"
        if session.degraded_cxl:
            # CXL brownout tripped the breaker during pre-install: the hot
            # set arrives over the RDMA fabric via the demand path — the
            # restore degrades, it does not fail
            session.drain_degraded_hot()
            self.events.append(f"degraded_restore:{host}:{name}")
            yield "restore:degraded"
        canonical = self.content[name][rec.version]
        if not inst.all_present() or not torch.equal(inst.image.buf, canonical.buf):
            raise InvariantViolation(
                f"[seed={self.seed} step={self.step_no}] {host}: restore of "
                f"{name!r} v{rec.version} is not bit-identical")
        self.restored.append({
            "host": host, "name": name, "version": rec.version,
            "retries": retries, "batched": use_batch,
            "degraded": session.degraded_cxl,
            "repairs": session.repair_stats["checksum_repairs"],
            "ledger": dict(inst.ledger.seconds),
            "uffd_copies": inst.stats["uffd_copies"],
            "uffd_zeropages": inst.stats["uffd_zeropages"],
        })
        yield "restore:verified"
        self.release(rec)
        yield "restore:released"

    def predicted_restore_program(self, host: str, name: str, heat_registry,
                                  max_extent_pages: int = 8):
        """Warm restore that installs cold extents in PREDICTED first-touch
        order (:class:`~repro_torch.core.prefetch_model.PredictedOrderPolicy` over
        the pod's heat telemetry) instead of layout order, one extent per
        scheduler turn, then verifies bit-identity against the canonical
        content — the §17 invariant: a policy re-orders fetches, it can
        never change installed bytes.  Falls back to layout order when the
        registry holds no sequence telemetry for the borrowed version."""
        from ..core.prefetch_model import PredictedOrderPolicy

        rec = yield from self.borrow_program_steps(host, name)
        if rec is None:
            self.events.append(f"cold_start:{host}")
            return
        view = self.pool.host_view(host)
        reader = SnapshotReader(rec.borrow.regions, view, self.pool.rdma)
        reader.invalidate_cxl()
        manifest, _meta = reader.machine_state()
        inst = Instance(StateImage.empty_like(manifest, device=self.device),
                        clock=self.clock)
        session = RestoreSession(reader, inst, None, clock=self.clock)
        session.heat = heat_registry.find(name, rec.version)
        yield "restore:setup"
        inst.uffd_zeropage_runs(reader.zero_runs())
        session.pre_install_hot()
        yield "restore:hot"
        policy = PredictedOrderPolicy(max_extent_pages)
        predicted = (session.heat is not None
                     and session.heat.stats.get("seq_transitions", 0) > 0)
        for es, en, rank0, pool_off, nbytes in policy.order_extents(
                session, None):
            payload = self.pool.rdma.read(pool_off, nbytes)
            session._install_verified(
                np.arange(es, es + en),
                reader.split_cold_extent(rank0, en, payload))
            yield "restore:predicted_cold"
        canonical = self.content[name][rec.version]
        if not inst.all_present() or not torch.equal(inst.image.buf,
                                                     canonical.buf):
            raise InvariantViolation(
                f"[seed={self.seed} step={self.step_no}] {host}: predicted-"
                f"order restore of {name!r} v{rec.version} is not "
                f"bit-identical")
        self.restored.append({
            "host": host, "name": name, "version": rec.version,
            "predicted_order": predicted,
            "ledger": dict(inst.ledger.seconds),
            "uffd_copies": inst.stats["uffd_copies"],
        })
        self.events.append(
            f"predicted_restore:{host}:{name}:"
            f"{'model' if predicted else 'layout'}")
        yield "restore:verified"
        self.release(rec)
        yield "restore:released"

    # ------------------------------------------------------------------
    # multi-pod program library (n_pods > 1; DESIGN.md §16)
    # ------------------------------------------------------------------
    def _drive_group_steps(self, tag: str, name: str, gen, img,
                           drain_limit: Optional[int], drain_sleep: float):
        """Shared wrapper over the ReplicaManager step generators: tracks
        per-pod pending regions for I6, records canonical content (``img``)
        the moment a replica republishes (``pod<i>:done``), translates
        drain/busy labels into scheduler sleeps, and aborts on
        ``drain_limit`` exhaustion."""
        polls = 0
        built: Dict[int, object] = {}
        with contextlib.closing(gen):
            for label, val in gen:
                pid, base = split_pod_label(label)
                if pid is not None and base in ("built_new", "rebuilt"):
                    built[pid] = val
                    self.pending_by_pod.setdefault(pid, []).append(val)
                elif pid is not None and base == "done":
                    if pid in built:
                        self.pending_by_pod[pid].remove(built.pop(pid))
                    # this replica is borrowable NOW: a borrower scheduled next
                    # turn must find the version's canonical bytes
                    if img is not None:
                        self.content.setdefault(name, {})[val.version] = img
                    self.events.append(f"{tag}:{name}:pod{pid}:v{val.version}")
                elif label == "done":
                    self.events.append(f"{tag}_done:{name}")
                yield f"{tag}:{label}"
                if base in ("draining", "owner_busy", "gc_pending") \
                        or label == "group_busy":
                    polls += 1
                    if drain_limit is not None and polls >= drain_limit:
                        self.events.append(f"drain_timeout:{name}")
                        return
                    yield ("sleep", drain_sleep)

    def group_publish_program(self, name: str, value: float,
                              pods: Optional[List[int]] = None,
                              drain_limit: Optional[int] = None,
                              drain_sleep: float = 1e-5,
                              dedup: Optional[bool] = None,
                              image: Optional[Tuple[StateImage, np.ndarray]] = None,
                              **image_kw):
        """Replicated publish/update through ``ReplicaManager.publish_steps``
        (group version, lockstep barrier), one protocol phase per turn.
        ``image`` — an ``(image, working_set)`` pair on the cluster's device
        — is published instead of :meth:`make_image`'s (``value`` and
        ``image_kw`` are then unused); it becomes the version's canonical
        content all the same."""
        img, ws = image if image is not None else self.make_image(value, **image_kw)
        gen = self.replicas.publish_steps(name, img, ws, pods=pods,
                                          dedup=dedup)
        yield from self._drive_group_steps("gpub", name, gen, img,
                                           drain_limit, drain_sleep)

    def group_delete_program(self, name: str,
                             drain_limit: Optional[int] = None,
                             drain_sleep: float = 1e-4):
        """Replicated delete: tombstones every replica, then drains/GCs
        each pod — the cross-pod delete drain window of I7."""
        gen = self.replicas.delete_steps(name)
        yield from self._drive_group_steps("gdel", name, gen, None,
                                           drain_limit, drain_sleep)

    def migrate_program(self, name: str, dst_pod: int, expected_reads: int,
                        drop_source: bool = False,
                        drain_limit: Optional[int] = None,
                        drain_sleep: float = 1e-4):
        """Break-even-gated migration through ``MigrationManager``: adds a
        replica at the current version (bit-identical reconstruction) and
        optionally retires the least-demanded source."""
        gen = self.migrator.migrate_steps(name, dst_pod, expected_reads,
                                          drop_source=drop_source)
        yield from self._drive_group_steps("migrate", name, gen, None,
                                           drain_limit, drain_sleep)

    def group_borrower_program(self, host: str, name: str, attempts: int = 4,
                               read_pages: int = 2, pause_s: float = 1e-4):
        """Borrow via replica routing: home-pod CXL when an MHD port
        grants (held for the borrow, detached at release), else inter-pod
        RDMA to the least-served reachable replica; partitioned/dead pods
        fall back to cold start.  Hot reads are verified bit-identical to
        the canonical image; inter-pod reads are charged on the router
        (and a partition landing mid-read aborts the attempt cleanly)."""
        successes = 0
        for i in range(attempts):
            route = self.replicas.borrow_route(host, name)
            if route is None:
                self.events.append(f"cold_start:{host}")
                yield ("sleep", pause_s)
                continue
            mode, pid = route
            pod = self.pods[pid]
            rec = None
            try:
                rec = yield from self.borrow_program_steps(host, name, pod=pid)
                if rec is None:
                    self.events.append(f"cold_start:{host}")
                    yield ("sleep", pause_s)
                    continue
                view = pod.pool.host_view(f"{host}:g{i}")
                reader = SnapshotReader(rec.borrow.regions, view,
                                        pod.pool.rdma)
                reader.invalidate_cxl()
                yield "borrower:flushed"
                canonical = self.content[name][rec.version].pages_matrix()
                for p in reader.hot_page_indices()[:read_pages]:
                    if mode == "interpod":
                        # remote replica: the page crosses the inter-pod
                        # fabric — modeled charge + partition check
                        try:
                            self.router.charge_read(host, pid, 4096)
                        except PodLinkDown:
                            self.events.append(
                                f"partition_abort:{host}:{name}")
                            break
                    got = reader.read_page(int(p))
                    if not torch.equal(got, canonical[int(p)]):
                        raise InvariantViolation(
                            f"[seed={self.seed} step={self.step_no}] {host} "
                            f"observed torn/stale bytes of {name!r} "
                            f"v{rec.version} page {int(p)} on pod {pid}")
                    yield f"borrower:read:{mode}"
                else:
                    successes += 1
            finally:
                if rec is not None:
                    self.release(rec)
                if mode == "cxl":
                    pod.ports.detach(host)
            yield "borrower:released"
            yield ("sleep", pause_s)
        self.events.append(f"group_borrower_done:{host}:{successes}/{attempts}")

    def partition_program(self, a: int, b: int, delay_s: float,
                          up: bool = False):
        """Scripted fabric event: after ``delay_s`` of simulated time the
        data-plane link between pods ``a`` and ``b`` goes down (or comes
        back with ``up=True``); catalog atomics are unaffected."""
        yield ("sleep", delay_s)
        self.group.set_partition(a, b, up=up)
        self.events.append(
            f"{'heal' if up else 'partition'}:{a}-{b}")
        yield "partitioned" if not up else "healed"

    def pod_loss_program(self, pod_id: int, delay_s: float):
        """Scripted pod loss: after ``delay_s`` the pod dies and the
        replica manager promotes survivors; names that lost their last
        replica are recorded as ``replica_lost:<name>`` events."""
        yield ("sleep", delay_s)
        lost = self.replicas.promote(pod_id)
        self.events.append(f"pod_lost:{pod_id}")
        for name in lost:
            self.events.append(f"replica_lost:{name}")
        yield "pod_lost"
