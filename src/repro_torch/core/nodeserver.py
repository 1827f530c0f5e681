"""Host-wide page-serving runtime (§3.5, §5.3 deployment regime).

The paper's deployment story is many co-located restores per host sharing
ONE RNIC and ONE CXL link.  A :class:`NodePageServer` is that host's single
serving runtime: one shared :class:`~repro_torch.core.serving.AsyncRDMAEngine`,
one completion worker and one prefetch pump multiplex every active
:class:`~repro_torch.core.serving.RestoreEngine` session on the host, instead
of the engine + worker thread + BufferPool + completion thread that each
restore builds privately without it.

What the shared runtime buys:

* **Demand-over-prefetch priority across instances** — demand faults from
  ANY instance are posted urgent on the shared submit queue, so they
  overtake every queued prefetch extent, including a neighbour's.
* **Cross-instance fairness** — prefetch extents are drained round-robin
  with a deficit counter (DRR) across fan-out groups, so a heavy
  prefetcher cannot starve a co-located light restore.
* **Cross-instance doorbell batching** — the pump coalesces posts from
  multiple restores into one doorbell, amortizing the per-op latency
  budget (QP-depth pipelining) across instances instead of per instance.
* **Hot-chunk fan-out** — when k instances concurrently restore the same
  ``(name, version)``, each CXL hot chunk and each RDMA cold extent is
  physically read ONCE and scattered k times (:class:`HotChunkCache`,
  refcounted per group, released on un-borrow).  The link then carries 1x
  bytes instead of kx, which the per-host :class:`~repro_torch.core.pool.LinkArbiter`
  turns into k-fold lower modeled contention.

Lifecycle: the server parks its threads when the last session detaches and
restarts them on the next attach, so idle hosts carry no thread residue.

Cached chunks, demand buffers and extent buffers are tensors on the pool's
device; queues, groups, in-flight maps and stats are host state.  The pump,
the completion worker and every session's own thread launch copies and
kernels on the device's current stream, so a buffer handed back after an
install is rewritten only after that install on the device.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import trace
from .faults import call_with_retries
from .pagestore import PAGE_SIZE
from .pool import HierarchicalPool, TimeLedger
from .prefetch_model import PrefetchPolicy, resolve_policy
from .serving import AsyncRDMAEngine, BufferPool, Instance, RestoreEngine, ScatterFn
from .snapshot import SnapshotReader


class _ChunkEntry:
    __slots__ = ("data", "modeled_s", "ready")

    def __init__(self):
        self.data: Optional[torch.Tensor] = None
        self.modeled_s = 0.0
        self.ready = threading.Event()


class HotChunkCache:
    """Refcounted fan-out cache: one physical read, k borrowers.

    Entries are keyed ``(group_key, byte_offset, nbytes)`` for the private
    snapshot layout — or ``("content", byte_offset, nbytes)`` for dedup
    snapshots, where equal store offsets imply equal BYTES, so co-located
    restores of *different variants* share one physical read.  The first
    requester (the leader) performs the read and records the modeled seconds
    it was charged; followers wait on the entry and replay the same charge to
    their own ledger — they logically waited for the same transfer, but the
    link only carried the bytes once.

    Every entry tracks the set of fan-out groups that touched it; an entry is
    dropped once the LAST owning group un-borrows (for per-group keys that is
    exactly the old one-group lifetime).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[object, int, int], _ChunkEntry] = {}
        self._owners: Dict[Tuple[object, int, int], set] = {}
        self.stats = {"reads": 0, "fanout_hits": 0, "cross_group_hits": 0}

    def get_or_read(self, key, read_fn, owner=None) -> Tuple[torch.Tensor, float, bool]:
        """-> (data, modeled_s, was_leader); `read_fn() -> (data, modeled_s)`.
        ``owner`` is the fan-out group holding the entry alive (defaults to
        ``key[0]``, the pre-content-keying behaviour)."""
        owner = key[0] if owner is None else owner
        with self._lock:
            entry = self._entries.get(key)
            leader = entry is None
            if leader:
                entry = self._entries[key] = _ChunkEntry()
            owners = self._owners.setdefault(key, set())
            cross = not leader and owner not in owners
            owners.add(owner)
        if leader:
            try:
                entry.data, entry.modeled_s = read_fn()
            finally:
                entry.ready.set()
            with self._lock:
                self.stats["reads"] += 1
            trace.count("nodeserver.chunk_reads")
            return entry.data, entry.modeled_s, True
        with trace.span("nodeserver.chunk_wait"):
            entry.ready.wait(timeout=30.0)
        if entry.data is None:      # leader failed: fall back to a private read
            data, t = read_fn()
            return data, t, True
        with self._lock:
            self.stats["fanout_hits"] += 1
            if cross:
                self.stats["cross_group_hits"] += 1
        if cross:
            trace.count("nodeserver.cross_group_hits")
        return entry.data, entry.modeled_s, False

    def drop_group(self, group_key) -> int:
        with self._lock:
            dead = []
            for k, owners in self._owners.items():
                owners.discard(group_key)
                if not owners:
                    dead.append(k)
            for k in dead:
                del self._owners[k]
                self._entries.pop(k, None)
            return len(dead)


class _Extent:
    __slots__ = ("es", "en", "rank0", "pool_off", "nbytes")

    def __init__(self, es, en, rank0, pool_off, nbytes):
        self.es, self.en, self.rank0 = es, en, rank0
        self.pool_off, self.nbytes = pool_off, nbytes


class FanoutGroup:
    """All co-located sessions restoring one published ``(name, version)``."""

    def __init__(self, key, reader: SnapshotReader):
        self.key = key
        self.reader = reader
        self.sessions: Dict[int, RestoreEngine] = {}
        self.queue: Deque[_Extent] = deque()
        self.deficit = 0
        self.enqueued = False
        self.poster: Optional[RestoreEngine] = None
        # ordering policy behind the queue (DESIGN.md §17): kept only when
        # it wants demand-miss re-seeding (PredictedOrderPolicy)
        self.policy: Optional[PrefetchPolicy] = None
        self.policy_session: Optional[RestoreEngine] = None
        # extent starts currently covered by the pump (queued or in flight):
        # a session joining AFTER some extents completed re-enqueues exactly
        # the ones it still needs (they are no longer in this set)
        self.covered: set = set()


class NodePageServer:
    """One per host: the shared page-serving runtime for all restores."""

    DRR_QUANTUM = 1 << 20    # prefetch bytes a group may post per DRR round

    def __init__(self, host: str, pool: HierarchicalPool,
                 buffer_pool_pages: int = 512, poll_budget: int = 1024,
                 drr_quantum: Optional[int] = None, heat=None):
        self.host = host
        self.pool = pool
        # online hotness feedback: a HeatRegistry shared with the pod's
        # PoolMaster; every attached session reports per-(name, version)
        # demand-fault / prefetch-hit / touch telemetry into it
        self.heat = heat
        self.drr_quantum = drr_quantum or self.DRR_QUANTUM
        self.engine = AsyncRDMAEngine(pool.rdma, TimeLedger(),
                                      poll_budget=poll_budget, host=host,
                                      start=False)
        self.buffers = BufferPool(buffer_pool_pages, device=pool.device)
        self.chunks = HotChunkCache()
        self._cxl_arbiter = pool.cxl.arbiter_for(host)
        self._rdma_arbiter = pool.rdma.arbiter_for(host)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._lifecycle = threading.Lock()
        self._stop = threading.Event()
        self._sem = threading.Semaphore(max(1, pool.rdma.cost.max_inflight))
        self._groups: Dict[object, FanoutGroup] = {}
        self._sessions: Dict[int, RestoreEngine] = {}
        self._completion_thread: Optional[threading.Thread] = None
        self._pump_thread: Optional[threading.Thread] = None
        self.stats = {"attached": 0, "detached": 0, "demand_reads": 0,
                      "extents_posted": 0, "extents_skipped": 0,
                      "doorbells": 0, "fanout_installs": 0,
                      "demand_fanout_installs": 0, "prefetch_reseeds": 0}
        # post order of (group_key, extent_start): fairness is observable
        self.post_order: Deque[Tuple[object, int]] = deque(maxlen=4096)

    # -- session lifecycle ---------------------------------------------------
    def attach(self, name: str, version: int, reader: SnapshotReader,
               instance: Instance,
               scatter_fn: Optional[ScatterFn] = None) -> RestoreEngine:
        """Join the host runtime; sessions restoring the same ``(name,
        version)`` form one fan-out group (ONE arbiter stream: their reads
        are served by shared physical transfers)."""
        session = RestoreEngine(reader, instance, rdma_engine=None,
                                buffer_pool=self.buffers,
                                scatter_fn=scatter_fn, server=self)
        if self.heat is not None:
            hm = self.heat.map_for(name, version, instance.image.total_pages)
            hm.note_restore()
            session.heat = hm
        gkey = (name, version)
        with self._lifecycle:
            self._ensure_running()
            with self._lock:
                group = self._groups.get(gkey)
                if group is None:
                    group = self._groups[gkey] = FanoutGroup(gkey, reader)
                    self._cxl_arbiter.register(gkey)
                    self._rdma_arbiter.register(gkey)
                group.sessions[id(session)] = session
                self._sessions[id(session)] = session
                session._group = group
            self.stats["attached"] += 1
        return session

    def detach(self, session: RestoreEngine) -> None:
        """Un-borrow: leave the group; the last session out drops the
        group's fan-out cache entries and its arbiter stream, and parks the
        runtime threads when the host goes fully idle."""
        with self._lifecycle:
            with self._lock:
                self._sessions.pop(id(session), None)
                group = session._group
                session._group = None
                emptied = False
                if group is not None:
                    group.sessions.pop(id(session), None)
                    if not group.sessions:
                        self._groups.pop(group.key, None)
                        group.queue.clear()
                        emptied = True
                idle = not self._sessions
            if group is not None and emptied:
                self.chunks.drop_group(group.key)
                self._cxl_arbiter.unregister(group.key)
                self._rdma_arbiter.unregister(group.key)
            self.stats["detached"] += 1
            if idle:
                self._park()

    def close(self) -> None:
        """Park the runtime if the host is idle.  With sessions still
        attached this is a no-op — live restores stay wired to a running
        engine, and the threads park on the last detach anyway."""
        with self._lifecycle:
            with self._lock:
                busy = bool(self._sessions)
            if not busy:
                self._park()

    def _ensure_running(self) -> None:
        if self._pump_thread is not None:
            return
        self._stop.clear()
        self.engine.start()
        self._completion_thread = threading.Thread(
            target=self._completion_loop, daemon=True)
        self._completion_thread.start()
        self._pump_thread = threading.Thread(target=self._pump_loop, daemon=True)
        self._pump_thread.start()

    def _park(self) -> None:
        """Stop threads, drain the engine, keep the server reusable."""
        self._stop.set()
        with self._work:
            self._work.notify_all()
        for t in (self._pump_thread, self._completion_thread):
            if t is not None:
                t.join(timeout=5.0)
        self._pump_thread = self._completion_thread = None
        self.engine.quiesce()
        while True:     # orphaned completions: return buffers / QP slots
            item = self.engine.poll_completion(block=False)
            if item is None:
                break
            self._route(*item)
        self.engine.close()
        self._stop.clear()

    # -- hot-chunk fan-out ----------------------------------------------------
    def hot_chunk(self, session: RestoreEngine, off: int, nbytes: int) -> torch.Tensor:
        trace.count("nodeserver.hot_chunk_requests")
        with trace.span("nodeserver.hot_chunk"):
            group = session._group
            if session.reader.regions.dedup:
                # content-keyed: equal store offsets == equal bytes under dedup,
                # so co-located restores of DIFFERENT variants (distinct fan-out
                # groups) share one physical read of their common base chunks
                key = ("content", off, nbytes)
            else:
                with self._lock:
                    solo = len(group.sessions) <= 1
                if solo:
                    # nothing to fan out to — don't duplicate the hot region in
                    # the cache for the common one-restore-per-snapshot case
                    return call_with_retries(
                        lambda: session.reader.view.read(off, nbytes),
                        policy=session.retry, rng=session._retry_rng,
                        ledger=session.ledger, clock=session.clock,
                        trace=session.retry_trace)
                key = (group.key, off, nbytes)
            # fan-out-aware retry (§15): only the LEADER's physical read can
            # fault, and its bounded retries happen here — once — so a failed
            # shared chunk read is re-issued once for the whole group, not k
            # times by k borrowers
            data, modeled_s, leader = self.chunks.get_or_read(
                key,
                lambda: call_with_retries(
                    lambda: session.reader.view.read_charged(off, nbytes),
                    policy=session.retry, rng=session._retry_rng,
                    ledger=session.ledger, clock=session.clock,
                    trace=session.retry_trace),
                owner=group.key)
            if not leader:
                # borrower: the bytes crossed the link once (leader's read);
                # we waited for the same transfer, so we model the same time
                session.ledger.add("cxl_read", modeled_s)
            return data

    # -- demand faults ---------------------------------------------------------
    def submit_demand(self, session: RestoreEngine, pool_off: int, nbytes: int,
                      buf: torch.Tensor, token_tail: tuple) -> None:
        """Urgent one-sided read for a demand fault: overtakes every queued
        prefetch extent from EVERY co-located instance.

        Fan-out: the page is marked in flight in every session of the
        group BEFORE posting, so a sibling faulting the same page records a
        ``prefetch_hit`` and waits for this read instead of posting a
        duplicate — one physical read credits (and installs into) the whole
        group, mirroring the pump's ``gext`` behaviour.  A predicted-order
        policy additionally re-seeds the group's queued extents from the
        faulting page (the model's next-touch chain restarts here)."""
        page = int(token_tail[0])
        group = session._group
        gkey = None
        if group is not None:
            gkey = group.key
            with self._lock:
                others = [s for s in group.sessions.values()
                          if s is not session]
            for s in others:
                with s._inflight_lock:
                    s._inflight.setdefault(page, True)
        self.stats["demand_reads"] += 1
        self.engine.submit_read(pool_off, nbytes, buf,
                                ("spage", id(session), gkey) + token_tail,
                                urgent=True, ledger=session.ledger)
        self._reseed_prefetch(session, page)

    def _reseed_prefetch(self, session: RestoreEngine, page: int) -> None:
        """Demand miss under a predicted-order policy: re-order the group's
        still-queued extents by the prediction seeded at the faulting page.
        Only the fetch ORDER changes — covered/queued membership does not,
        so installs stay bit-identical."""
        group = session._group
        if group is None:
            return
        with self._lock:
            policy = group.policy
            if policy is None or not group.queue:
                return
        rank = {es: i for i, (es, _en, _r0, _off, _nb)
                in enumerate(policy.order_extents(session, faulting_page=page))}
        with self._work:
            if not group.queue:
                return
            q = sorted(group.queue, key=lambda e: rank.get(e.es, len(rank)))
            group.queue.clear()
            group.queue.extend(q)
            self.stats["prefetch_reseeds"] += 1
            self._work.notify_all()

    # -- prefetch pump ---------------------------------------------------------
    def enqueue_prefetch(self, session: RestoreEngine,
                         policy: Optional[PrefetchPolicy] = None) -> None:
        """Queue the group's cold extents in ``policy`` order (default
        :class:`LayoutOrderPolicy`: largest runs first); completed extents
        are scattered into every session of the group.

        The first caller enqueues the full walk.  A session that joins the
        group LATER re-enqueues only the extents it still needs and the
        pump no longer covers (an extent that is queued or in flight will
        install into this session on completion, so it is never duplicated;
        one already completed before this session attached is re-fetched)."""
        policy = resolve_policy(policy)
        group = session._group
        if group is None:
            return
        extents = [_Extent(*tup)
                   for tup in policy.order_extents(session, None)]
        present = session.instance.present

        def needs(ext: _Extent) -> bool:
            """True iff some page of the extent will NOT reach this session:
            not covered by the pump, not installed, and not already arriving
            via an in-flight read (pump-marked extent or demand single)."""
            if ext.es in group.covered:
                return False
            if present[ext.es : ext.es + ext.en].all():
                return False
            with session._inflight_lock:
                return not all(present[p] or session._inflight.get(p)
                               for p in range(ext.es, ext.es + ext.en))

        with self._work:
            # decide first-vs-joiner and fill queue+covered in ONE critical
            # section: a concurrent enqueuer must observe the full walk as
            # covered, never a half-filled one (else it would duplicate it)
            first = not group.enqueued
            group.enqueued = True
            if first:
                group.poster = session
            if policy.reseed_on_demand:
                group.policy = policy
                group.policy_session = session
            for ext in extents:
                if not first and not needs(ext):
                    continue
                group.covered.add(ext.es)
                group.queue.append(ext)
            self._work.notify_all()

    def _flush_doorbell(self, pend: Dict[FanoutGroup, List[int]]) -> None:
        """One doorbell over extents from possibly MANY groups: the QP-depth
        latency budget is amortized across the whole batch and split by op
        share; every session of a group is charged the group's share (they
        all wait on the same shared transfer)."""
        if not pend:
            return
        cost = self.pool.rdma.cost
        total_ops = sum(o for _b, o in pend.values())
        lat_total = -(-total_ops // max(1, cost.max_inflight)) * cost.op_latency_s
        for group, (nbytes, ops) in pend.items():
            serial_g = (ops / total_ops) * lat_total + nbytes / cost.bandwidth_Bps
            t_g = self._rdma_arbiter.shared(serial_g, nbytes)
            with self._lock:
                sessions = list(group.sessions.values())
            for s in sessions:
                s.ledger.add("rdma_prefetch", t_g)
                s.prefetch_stats["doorbells"] += 1
        self.stats["doorbells"] += 1
        pend.clear()

    def _pump_loop(self) -> None:
        qp = max(1, self.pool.rdma.cost.max_inflight)
        pend: Dict[FanoutGroup, List[int]] = {}

        def pend_ops() -> int:
            return sum(o for _b, o in pend.values())

        while not self._stop.is_set():
            with self._work:
                ready = [g for g in self._groups.values() if g.queue]
                if not ready:
                    pass_groups = None
                else:
                    pass_groups = ready
            if pass_groups is None:
                self._flush_doorbell(pend)
                with self._work:
                    if not any(g.queue for g in self._groups.values()):
                        self._work.wait(timeout=0.05)
                continue
            for group in pass_groups:       # one DRR round
                if self._stop.is_set():
                    break
                group.deficit += self.drr_quantum
                while True:
                    with self._lock:
                        if not group.queue:
                            group.deficit = 0
                            break
                        ext = group.queue[0]
                        if ext.nbytes > group.deficit:
                            break
                        group.queue.popleft()
                        group.deficit -= ext.nbytes
                        sessions = list(group.sessions.values())
                    if not sessions or all(
                            s.instance.present[ext.es : ext.es + ext.en].all()
                            for s in sessions):
                        with self._lock:
                            group.covered.discard(ext.es)
                        self.stats["extents_skipped"] += 1
                        continue
                    got = False
                    while not got:
                        got = self._sem.acquire(timeout=0.05)
                        if self._stop.is_set():
                            if got:
                                self._sem.release()
                            self._flush_doorbell(pend)
                            return
                    for s in sessions:
                        with s._inflight_lock:
                            for p in range(ext.es, ext.es + ext.en):
                                s._inflight.setdefault(p, True)
                    buf = torch.empty(ext.nbytes, dtype=torch.uint8,
                                      device=self.pool.device)
                    self.engine.submit_read(
                        ext.pool_off, ext.nbytes, buf,
                        ("gext", group.key, ext.es, ext.en, ext.rank0),
                        urgent=False, charge=False)
                    if group.poster is not None:
                        group.poster.prefetch_stats["extents_posted"] += 1
                    self.stats["extents_posted"] += 1
                    self.post_order.append((group.key, ext.es))
                    b_o = pend.setdefault(group, [0, 0])
                    b_o[0] += ext.nbytes
                    b_o[1] += 1
                    if pend_ops() >= qp:
                        self._flush_doorbell(pend)
            self._flush_doorbell(pend)
        self._flush_doorbell(pend)

    # -- completion routing -----------------------------------------------------
    def _install(self, s: RestoreEngine, pages: np.ndarray, mat: torch.Tensor) -> int:
        """One install into a session, its wait for the session's lock
        included (a batched restore walk holds that lock until its flush)."""
        with trace.span("nodeserver.install", s.req):
            return s._install_verified(pages, mat)

    def _route(self, buf: torch.Tensor, token: tuple, t_done: int = 0, req=None) -> None:
        trace.add("rdma.cq_wait", t_done, trace.now(), req)
        if token[0] == "gext":
            _tag, gkey, es, en, rank0 = token
            with self._lock:
                group = self._groups.get(gkey)
                sessions = list(group.sessions.values()) if group else []
                reader = group.reader if group else None
                if group is not None:
                    # un-cover INSIDE the snapshot's critical section: a
                    # joiner that saw this extent as covered is in `sessions`
                    group.covered.discard(es)
            try:
                if sessions:
                    mat = reader.split_cold_extent(rank0, en, buf)
                    pages = np.arange(es, es + en)
                    for s in sessions:
                        try:
                            k = self._install(s, pages, mat)
                            s.prefetch_stats["pages_installed"] += k
                        except RuntimeError as e:
                            # pump context: record per session so one
                            # exhausted repair cannot sink its neighbours
                            if not s._is_fault(e):
                                raise
                            s.repair_error = e
                        finally:
                            with s._inflight_lock:
                                for p in range(es, es + en):
                                    s._inflight.pop(p, None)
                    if len(sessions) > 1:
                        self.stats["fanout_installs"] += len(sessions) - 1
            finally:
                self._sem.release()
            return
        _tag, sid, gkey, page, nbytes, raw, kind = token
        with self._lock:
            session = self._sessions.get(sid)
            group = self._groups.get(gkey) if gkey is not None else None
            if group is not None:
                # demand fan-out: the single physical read installs into
                # every session of the group (submit_demand marked the page
                # in flight in all of them)
                sessions = list(group.sessions.values())
                reader = group.reader
            else:
                sessions = [session] if session is not None else []
                reader = session.reader if session is not None else None
        try:
            if sessions:
                data = (reader.decompress_page(buf[:nbytes], raw)
                        if kind == "rdma_z" else buf[:PAGE_SIZE])
                for s in sessions:
                    try:
                        self._install(s, np.array([int(page)], dtype=np.int64), data)
                    except RuntimeError as e:
                        if not s._is_fault(e):
                            raise
                        s.repair_error = e
                    finally:
                        with s._inflight_lock:
                            s._inflight.pop(int(page), None)
                if len(sessions) > 1:
                    self.stats["demand_fanout_installs"] += len(sessions) - 1
        finally:
            self.buffers.release(buf)

    def _completion_loop(self) -> None:
        eng = self.engine
        while not self._stop.is_set():
            item = eng.poll_completion(block=True)
            if item is None:
                continue
            while item is not None:
                self._route(*item)
                polled = None
                for _ in range(eng.poll_budget):
                    polled = eng.poll_completion(block=False)
                    if polled is not None:
                        eng.stats["busy_polls"] += 1
                        break
                item = polled
