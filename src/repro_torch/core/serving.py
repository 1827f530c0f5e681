"""Copy-based page serving (§3.4, §4) — run-coalesced, on a torch device.

Restore = (1) pre-install the hot set from CXL *before* resume, then
(2) demand-page cold pages asynchronously from RDMA while the instance runs,
optionally with a background extent prefetcher walking the cold runs.

All installs go through the ``uffd.copy()`` analogue (`Instance.uffd_copy` /
`Instance.uffd_copy_batch`), which writes a *private copy* into the
instance's address space — the pool-resident snapshot is never modified.
Zero-page faults take the ``uffd.zeropage()`` fast path (§4).

Page bytes (guest image, tier arenas, chunks, demand buffers) are tensors on
the pool's device; the ``present`` bitmap, run indices, ledgers and stats
are host control state, as a real uffd handler keeps them.  The hot
pre-install walks the snapshot's hot extents (256-page chunks of the
rank-compacted region, or runs of adjacent store offsets for a dedup
snapshot), and each extent is installed by one in-place scatter call: a
``page_scatter`` by default, or with
:class:`~repro_torch.kernels.snapshot_fuse.FusedScatter` a fused
gather→verify→scatter.  The two bulk walks (the hot pre-install and the
cold walk of ``install_all_sync``) are *batched* when nothing in them can
observe it (no fault injector, a scatter with a batched form, and for a
verified walk no cached HostView line over its rows and a clean verify-only
launch over its source rows): every extent is accounted as before, its rows
are queued instead of scattered, and the walk ends with ONE kernel launch
over all its rows.  The hot walk reads each extent and queues the read; the
cold walk over a raw RDMA tier reads nothing: it queues the tier arena's own
rows (``MemoryTier.page_rows``) and accounts its extents with array
arithmetic.  ``RestoreEngine.walk_routes`` counts the walks by route.  A row
that mismatches at a batched walk's flush is repaired as the reference
repairs a mismatch in the middle of a walk: the good rows of its extent
install, and each bad page is re-read from its home tier under
``repair_budget``.

Async RDMA fault handling mirrors the paper: the fault handler grabs a free
buffer page, posts a one-sided read, and returns immediately; a completion
thread drains the CQ and installs fetched pages.  Under a host-wide
:class:`~repro_torch.core.nodeserver.NodePageServer` (``server=``) the engine,
buffers, completion worker and prefetch pump are the host's, shared by every
restore on it, and a session of a fan-out group reads each hot chunk through
the server's cache: the batched walk then queues rows of the cached chunk
tensors, so the group's one read per chunk holds on either route.  The
engine, completion and guest threads launch their copies and kernels on the
device's current stream.
"""
from __future__ import annotations

import contextlib
import itertools
import queue
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.page_scatter import page_scatter
from . import trace
from .clock import Clock, REAL_CLOCK
from .faults import (
    DEFAULT_RETRY_POLICY,
    RetryPolicy,
    TierFaultError,
    call_with_retries,
)
from .pagestore import PAGE_SIZE, StateImage, runs_from_pages
from .prefetch_model import PrefetchPolicy, resolve_policy
from .profiler import TouchEvent
from .pool import (
    MMAP_PER_PAGE_S,
    MMAP_SYSCALL_S,
    UFFD_COPY_PER_PAGE_S,
    UFFD_ZEROPAGE_PER_PAGE_S,
    MemoryTier,
    TimeLedger,
    uffd_copy_batch_cost,
    uffd_zeropage_range_cost,
)
from .snapshot import SnapshotReader

# scatter_fn(dest_matrix, compact, indices, src_indices=None), IN PLACE on
# device tensors: dest[indices[i]] = compact[src_indices[i]] (src_indices
# None means arange).  indices / src_indices are host int64 arrays.  The
# default is the page_scatter kernel (no verification);
# kernels/snapshot_fuse.FusedScatter plugs in here too, and RestoreEngine
# binds it to the snapshot's publish-time checksum table so every installed
# batch is verified inside the installing kernel launch.
ScatterFn = Callable[..., object]


class QueuedRows(tuple):
    """One queued row-list segment ``(source, rows, dst)`` (a scatter's
    batched form takes it as it is) and ``bounds``: the logical batches it
    holds, batch ``k`` being ``dst[bounds[k]:bounds[k + 1]]`` (None: one)."""

    def __new__(cls, source: torch.Tensor, rows: Optional[np.ndarray],
                dst: np.ndarray, bounds: Optional[np.ndarray] = None):
        seg = super().__new__(cls, (source, rows, dst))
        seg.bounds = bounds
        return seg

    def batches(self):
        """``(lo, hi)`` slices of ``dst`` a logical batch."""
        if self.bounds is None:
            return [(0, self[2].size)]
        return list(zip(self.bounds[:-1].tolist(), self.bounds[1:].tolist()))


class Instance:
    """A restoring/running instance's guest address space + present bitmap.

    Inside :meth:`queued_installs` (a batched restore walk) the scatter of
    each ``uffd_copy_batch`` the walk's thread makes is queued as a row-list
    segment instead of launched (and :meth:`queue_extents` queues a walk's
    extents straight from a tier arena's rows); the batch's stats, ledger
    charge and the scatter's batch stats happen as they would.  The flush
    installs every queued row with ONE call of the scatter's batched form
    and only then marks the rows' pages present, so no reader, with the lock
    or without, sees a page present whose bytes are not yet enqueued.  The
    instance's lock is held from the first queued segment to the flush:
    another thread installs directly before that, and waits for the flush
    after it.
    """

    # queued row bytes that force a flush mid-walk: bounds the memory the
    # queued extent buffers hold
    QUEUE_FLUSH_BYTES = 2 << 30

    def __init__(self, image: StateImage, ledger: Optional[TimeLedger] = None,
                 scatter_fn: Optional[ScatterFn] = None,
                 clock: Optional[Clock] = None):
        self.image = image
        self.present = np.zeros(image.total_pages, dtype=bool)
        self.ledger = ledger or TimeLedger()
        self.scatter_fn = scatter_fn
        self.clock = clock or REAL_CLOCK
        self.stats = {
            "pre_installed": 0,
            "fault_zero": 0,
            "fault_cxl": 0,
            "fault_rdma": 0,
            "uffd_copies": 0,
            "uffd_zeropages": 0,
            "uffd_batches": 0,
            "bytes_installed": 0,
        }
        self._lock = threading.RLock()     # re-entered while a walk's queue holds it
        self._cv = threading.Condition(self._lock)
        self._queue: Optional[list] = None           # queued (source, rows, pages)
        self._queue_bytes = 0
        self._queue_thread: Optional[int] = None     # the walk's thread
        self._launch_queue: Optional[Callable] = None
        self.flushes = 0                             # batched launches of queued rows

    # -- uffd analogues ------------------------------------------------------
    def uffd_copy(self, page: int, src: torch.Tensor) -> bool:
        with self._cv:
            if self.present[page]:
                return False
            self.image.write_page(page, src)
            self.present[page] = True
            self.stats["uffd_copies"] += 1
            self.stats["bytes_installed"] += PAGE_SIZE
            self.ledger.add("uffd_copy", UFFD_COPY_PER_PAGE_S)
            self._cv.notify_all()
            return True

    def uffd_copy_batch(self, pages: np.ndarray, mat: torch.Tensor,
                        rows: Optional[np.ndarray] = None) -> int:
        """Install many pages under ONE lock acquisition via one in-place
        scatter; the ledger is charged per contiguous range (one uffd.copy
        ioctl per range), not per page.  Page ``pages[i]`` comes from row
        ``rows[i]`` of ``mat`` (default: row ``i``).  Already-present pages
        are skipped: the scatter gathers the rest straight from ``mat`` by
        position.  Returns the number of pages actually installed."""
        pages = np.asarray(pages, dtype=np.int64).reshape(-1)
        if rows is None:
            mat = mat.reshape(pages.size, PAGE_SIZE)
        with self._cv:
            todo = ~self.present[pages]
            if not todo.any():
                return 0
            sel = pages[todo]
            if rows is not None:
                src = np.asarray(rows, dtype=np.int64).reshape(-1)[todo]
            else:
                src = None if todo.all() else np.nonzero(todo)[0]
            scatter = self.scatter_fn or page_scatter
            if self._queue is not None and threading.get_ident() == self._queue_thread:
                self._enqueue(scatter, mat, src, sel)     # present once flushed
            else:
                scatter(self.image.pages_matrix(), mat, sel, src_indices=src)
                self.present[sel] = True
            n = int(sel.size)
            n_ranges = int(1 + np.count_nonzero(np.diff(sel) != 1))
            self.stats["uffd_copies"] += n
            self.stats["uffd_batches"] += 1
            self.stats["bytes_installed"] += n * PAGE_SIZE
            self.ledger.add("uffd_copy", uffd_copy_batch_cost(n, n_ranges))
            self._cv.notify_all()
            return n

    def _enqueue(self, scatter, mat: torch.Tensor, src: Optional[np.ndarray],
                 sel: np.ndarray) -> None:
        """Queue one batch's scatter (caller holds the lock)."""
        count = getattr(scatter, "count_batch", None)
        if count is not None:
            count(sel.size)
        self._push(QueuedRows(mat, src, sel), mat.numel() * mat.element_size())

    def _push(self, seg: QueuedRows, nbytes: int) -> None:
        """Append a segment holding ``nbytes`` to the queue (caller holds the
        lock), and flush once the queue reaches its limit."""
        if not self._queue:
            self._lock.acquire()        # held until flush_queued
        self._queue.append(seg)
        self._queue_bytes += nbytes
        if self._queue_bytes >= self.QUEUE_FLUSH_BYTES:
            self.flush_queued()

    def queue_extents(self, mat: torch.Tensor, rows: np.ndarray, pages: np.ndarray,
                      bounds: np.ndarray) -> int:
        """Queue a batched walk's extents straight from rows of one source
        tensor (a tier arena's ``page_rows``): extent ``k`` installs
        ``pages[bounds[k]:bounds[k + 1]]`` (guest-ascending) from those
        ``rows`` of ``mat``.  Each extent is accounted as
        :meth:`uffd_copy_batch` accounts a batch (its pages not yet present,
        one uffd.copy range a guest run of them, the stats, the ledger's
        charge, the scatter's ``count_batch``), in extent order, by array
        arithmetic; the rows go into the queue as one segment a flush.  Only
        the walk's thread, inside :meth:`queued_installs`.  Returns the
        number of pages queued."""
        assert self._queue is not None and threading.get_ident() == self._queue_thread
        scatter = self.scatter_fn or page_scatter
        count = getattr(scatter, "count_batch", None)
        queued, k, n_ext = 0, 0, bounds.size - 1
        while k < n_ext:
            with self._cv:
                lo = int(bounds[k])
                todo = ~self.present[pages[lo:]]
                n = np.add.reduceat(todo, bounds[k:-1] - lo, dtype=np.int64)
                # the extents up to the first that takes the queue to its limit
                over = np.flatnonzero(
                    self._queue_bytes + np.cumsum(n) * PAGE_SIZE >= self.QUEUE_FLUSH_BYTES)
                j = int(over[0]) + 1 if over.size else n.size
                n, hi = n[:j], int(bounds[k + j])
                k += j
                has = n > 0
                if not has.any():
                    continue
                keep = todo[: hi - lo]
                sel, src = pages[lo:hi][keep], rows[lo:hi][keep]
                n = n[has]
                ext = np.repeat(np.arange(n.size), n)
                cut = (np.diff(sel) != 1) & (ext[1:] == ext[:-1])
                n_ranges = 1 + np.bincount(ext[1:][cut], minlength=n.size)
                self.stats["uffd_copies"] += int(sel.size)
                self.stats["uffd_batches"] += int(n.size)
                self.stats["bytes_installed"] += int(sel.size) * PAGE_SIZE
                self.ledger.add_each("uffd_copy", uffd_copy_batch_cost(n, n_ranges))
                if count is not None:
                    for m in n.tolist():
                        count(m)
                queued += int(sel.size)
                self._cv.notify_all()
                self._push(QueuedRows(mat, src, sel, np.concatenate(([0], np.cumsum(n)))),
                           int(sel.size) * PAGE_SIZE)
        return queued

    @contextlib.contextmanager
    def queued_installs(self, launch: Callable):
        """Queue every ``uffd_copy_batch`` scatter and :meth:`queue_extents`
        row list of the walk's thread inside the block and install them at
        its end (also on an error) with ONE ``launch(dest, segments)`` — a
        scatter function's batched form (``scatter_rows``)."""
        self._queue, self._queue_bytes, self._launch_queue = [], 0, launch
        self._queue_thread = threading.get_ident()
        try:
            yield
        finally:
            try:
                self.flush_queued()
            finally:
                self._queue = self._launch_queue = self._queue_thread = None

    def flush_queued(self) -> None:
        """Install the queued segments with one launch, mark their pages
        present once it is issued, and release the lock the first of them
        took."""
        if not self._queue:
            return
        segments, self._queue, self._queue_bytes = self._queue, [], 0
        try:
            with trace.span("serving.flush"):
                self.flushes += 1
                self._launch_queue(self.image.pages_matrix(), segments)
                for _mat, _src, sel in segments:
                    self.present[sel] = True
                self._cv.notify_all()
        finally:
            self._lock.release()

    @contextlib.contextmanager
    def direct_installs(self):
        """Inside a flush (the caller holds the lock), install directly
        instead of queueing: the flush's repair path re-installs rows."""
        thread, self._queue_thread = self._queue_thread, None
        try:
            yield
        finally:
            self._queue_thread = thread

    def unaccount_batch(self, scatter, sel: np.ndarray) -> None:
        """Take back what queueing the batch ``sel`` accounted (stats, the
        ledger's uffd.copy charge, the scatter's batch count), for a batch
        that failed at its flush and is installed again by the repair path.
        The caller holds the lock."""
        n = int(sel.size)
        n_ranges = int(1 + np.count_nonzero(np.diff(sel) != 1))
        self.stats["uffd_copies"] -= n
        self.stats["uffd_batches"] -= 1
        self.stats["bytes_installed"] -= n * PAGE_SIZE
        self.ledger.add("uffd_copy", -uffd_copy_batch_cost(n, n_ranges))
        uncount = getattr(scatter, "uncount_batch", None)
        if uncount is not None:
            uncount(n)

    def uffd_zeropage(self, page: int) -> None:
        with self._cv:
            if self.present[page]:
                return
            # image buffers start zeroed; mark present only
            self.present[page] = True
            self.stats["uffd_zeropages"] += 1
            self.ledger.add("uffd_zeropage", UFFD_ZEROPAGE_PER_PAGE_S)
            self._cv.notify_all()

    def uffd_zeropage_range(self, start: int, n: int) -> int:
        """Range form of uffd.zeropage: one lock acquisition, one ioctl per
        contiguous range actually zeroed (present pages split ranges)."""
        return self.uffd_zeropage_runs([[start, n]])

    def uffd_zeropage_runs(self, runs) -> int:
        """:meth:`uffd_zeropage_range` of each run of a table (int64
        ``(R, 2)`` ``[start, n]``, disjoint, as ``SnapshotReader.zero_runs``
        gives it; overlapping runs raise ValueError) in table order, under
        ONE lock acquisition, by array arithmetic over the pages the runs
        span: each run's pages not yet present are marked, one ioctl charged
        a contiguous range of them, and a run with none takes no batch and
        no charge.  Returns the number of pages marked."""
        runs = np.asarray(runs, dtype=np.int64).reshape(-1, 2)
        ends = np.minimum(runs[:, 0] + runs[:, 1], self.present.size)
        nonempty = ends > runs[:, 0]
        starts, ends = runs[nonempty, 0], ends[nonempty]
        if starts.size == 0:
            return 0
        lo, hi = int(starts.min()), int(ends.max())
        edges = np.empty(2 * starts.size, dtype=np.int64)    # each run's [start, end) from lo
        edges[0::2], edges[1::2] = starts - lo, ends - lo
        heads = edges[0::2]
        cuts = np.concatenate(
            ([0], edges.reshape(-1, 2)[np.argsort(starts)].reshape(-1), [hi - lo]))
        in_runs = np.repeat(np.arange(cuts.size - 1) % 2 == 1, np.diff(cuts))
        with self._cv:
            present = self.present[lo:hi]
            todo = np.zeros(hi - lo + 1, dtype=bool)         # not present; a pad for reduceat
            np.logical_not(present, out=todo[:-1])
            begins = todo.copy()                             # where a range of them begins
            begins[1:] &= ~todo[:-1]
            k = np.add.reduceat(todo, edges, dtype=np.int64)[0::2]
            # a run's first page begins its first range whatever precedes it
            n_ranges = (np.add.reduceat(begins, edges, dtype=np.int64)[0::2]
                        - begins[heads] + todo[heads])
            has = k > 0
            if not has.any():
                return 0
            k, n_ranges = k[has], n_ranges[has]
            present |= in_runs
            marked = int(k.sum())
            self.stats["uffd_zeropages"] += marked
            self.stats["uffd_batches"] += int(k.size)
            self.ledger.add_each("uffd_zeropage", uffd_zeropage_range_cost(k, n_ranges))
            self._cv.notify_all()
            return marked

    def wait_present(self, page: int, timeout_s: float = 30.0) -> bool:
        with self._cv:
            return self.clock.cv_wait_for(
                self._cv, lambda: self.present[page], timeout_s)

    def all_present(self) -> bool:
        return bool(self.present.all())


class BufferPool:
    """Local pool of free device page buffers for in-flight RDMA reads (§3.4).

    ``outstanding`` counts buffers currently acquired; a stopped engine may
    not strand demand-read buffers (tests assert ``outstanding == 0``).
    """

    def __init__(self, n_pages: int = 256, device="cuda"):
        self.capacity = n_pages
        self.outstanding = 0
        self._lock = threading.Lock()
        self._q: "queue.Queue[torch.Tensor]" = queue.Queue()
        for buf in torch.empty((n_pages, PAGE_SIZE), dtype=torch.uint8,
                               device=device).unbind(0):
            self._q.put(buf)

    def acquire(self) -> torch.Tensor:
        buf = self._q.get()
        with self._lock:
            self.outstanding += 1
        return buf

    def release(self, buf: torch.Tensor) -> None:
        with self._lock:
            self.outstanding -= 1
        self._q.put(buf)


class AsyncRDMAEngine:
    """Emulated one-sided RDMA read engine with a completion queue.

    A worker thread performs the actual byte copies (device to device, so
    data paths are real); modeled time is charged per-op on the ledger.  The
    submit queue is a two-level priority queue: demand-fault reads (urgent)
    overtake queued prefetch extents.  The completion handler busy-polls up
    to ``poll_budget`` iterations after each completion before falling back
    to blocking on the CQ (the paper's hybrid strategy, §4).
    """

    def __init__(self, tier: MemoryTier, ledger: TimeLedger, poll_budget: int = 1024,
                 host: str = "", start: bool = True,
                 retry_policy: Optional[RetryPolicy] = None):
        self.tier = tier
        self.ledger = ledger
        self.poll_budget = poll_budget
        self.arbiter = tier.arbiter_for(host)
        self.retry = retry_policy or DEFAULT_RETRY_POLICY
        # fixed engine seed: the injector's schedule decides WHICH ops fault,
        # so the backoff sequence is reproducible run-to-run regardless
        self._retry_rng = random.Random(0xA9E1)
        self._sq: "queue.PriorityQueue" = queue.PriorityQueue()
        self._seq = itertools.count()
        self._cq: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._pending_lock = threading.Lock()
        self._pending_ops = 0            # submitted, completion not yet queued
        self._worker: Optional[threading.Thread] = None
        self.stats = {"reads": 0, "busy_polls": 0, "event_waits": 0,
                      "urgent_reads": 0, "bytes_read": 0,
                      "injected_faults": 0, "retries": 0, "retry_exhausted": 0}
        if start:
            self.start()

    def start(self) -> None:
        """(Re)start the worker thread; a no-op while it is running."""
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop.clear()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit_read(self, pool_off: int, nbytes: int, buf: torch.Tensor, token,
                    urgent: bool = False, charge: bool = True,
                    ledger: Optional[TimeLedger] = None) -> None:
        """Post a one-sided read of `nbytes` at `pool_off` into `buf`.

        ``urgent`` reads (demand faults) are served before queued prefetch
        extents.  ``charge=False`` suppresses the per-op ledger charge for
        callers that account a whole doorbell batch themselves."""
        prio = 0 if urgent else 1
        with self._pending_lock:
            self._pending_ops += 1
        self._sq.put((prio, next(self._seq),
                      (pool_off, nbytes, buf, token, charge, ledger, trace.now(),
                       trace.REQ.get())))

    def quiesce(self, timeout_s: float = 5.0) -> bool:
        """Wait until every submitted read has executed and its completion
        is queued on the CQ (the CQ itself may still hold entries)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._pending_lock:
                if self._pending_ops == 0:
                    return True
            time.sleep(0.002)
        return False

    def poll_completion(self, block: bool, timeout_s: float = 0.05):
        """-> ``(buf, token, t_done_ns, req)`` or None: the read's buffer and
        token, and for tracing when its completion was queued (0 while
        tracing is off) and the request that submitted it.  Emulates CQ
        poll / completion channel."""
        try:
            return self._cq.get_nowait()
        except queue.Empty:
            if not block:
                return None
        self.stats["event_waits"] += 1
        try:
            return self._cq.get(timeout=timeout_s)
        except queue.Empty:
            return None

    def _execute_read(self, prio: int, pool_off: int, nbytes: int,
                      buf: torch.Tensor, ledger: Optional[TimeLedger]) -> None:
        """One wire attempt plus bounded in-place retries.  Every failed
        attempt is charged through the arbiter plus a seeded backoff; an
        exhausted budget escalates to a final clean read."""
        led = ledger or self.ledger
        fi = getattr(self.tier, "fault_injector", None)
        src = self.tier.buf[pool_off : pool_off + nbytes]
        attempt = 0
        while True:
            try:
                if fi is not None:
                    fi.check_read(self.tier.name, pool_off, nbytes,
                                  host_link=True)
                buf[:nbytes].copy_(src)
                if fi is not None:
                    fi.filter_read(self.tier.name, pool_off, nbytes,
                                   buf[:nbytes])
                    fi.check_completion(self.tier.name)
                return
            except TierFaultError:
                self.stats["injected_faults"] += 1
                led.add("rdma_retry", self.arbiter.charge(nbytes))
                if attempt >= self.retry.max_retries:
                    self.stats["retry_exhausted"] += 1
                    buf[:nbytes].copy_(src)
                    return
                self.stats["retries"] += 1
                led.add("retry_backoff",
                        self.retry.backoff_s(attempt, self._retry_rng,
                                             urgent=(prio == 0)))
                attempt += 1

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                prio, _seq, (pool_off, nbytes, buf, token, charge, ledger, t_sub, req) = (
                    self._sq.get(timeout=0.05))
            except queue.Empty:
                continue
            t_deq = trace.now()
            self._execute_read(prio, pool_off, nbytes, buf, ledger)
            t_done = trace.now()
            trace.add("rdma.queue_wait", t_sub, t_deq, req)
            trace.add("rdma.read", t_deq, t_done, req)
            self.stats["reads"] += 1
            self.stats["bytes_read"] += nbytes
            if prio == 0:
                self.stats["urgent_reads"] += 1
            if charge:
                (ledger or self.ledger).add("rdma_read", self.arbiter.charge(nbytes))
            self._cq.put((buf, token, t_done, req))
            with self._pending_lock:
                self._pending_ops -= 1

    def close(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=1.0)


class RestoreEngine:
    """Per-instance page server: run-coalesced hot pre-install + async cold
    demand-paging + optional background extent prefetch over the cold runs."""

    def __init__(
        self,
        reader: SnapshotReader,
        instance: Instance,
        rdma_engine: Optional[AsyncRDMAEngine] = None,
        buffer_pool: Optional[BufferPool] = None,
        scatter_fn: Optional[ScatterFn] = None,
        clock: Optional[Clock] = None,
        server=None,
        retry_policy: Optional[RetryPolicy] = None,
        retry_seed: int = 0,
        policy: Optional[PrefetchPolicy] = None,
    ):
        self.reader = reader
        self.instance = instance
        if scatter_fn is not None:
            # fused restore: bind the snapshot's publish-time checksum table
            # (when the publish recorded one) so the scatter that installs
            # each batch also verifies it — covers pre_install_hot,
            # install_all_sync, demand/prefetch installs AND the
            # NodePageServer fan-out installs, all of which land in
            # Instance.uffd_copy_batch
            table = (reader.page_checksums()
                     if hasattr(scatter_fn, "bind_checksums") else None)
            if table is not None:
                scatter_fn = scatter_fn.bind_checksums(table)
            self.instance.scatter_fn = scatter_fn
        if clock is not None:
            # route the engine's clock to the instance too: page waits
            # (wait_present) are the engine's only timed behaviour
            self.instance.clock = clock
        self.clock = clock or instance.clock
        self.ledger = instance.ledger
        self.rdma_engine = rdma_engine
        # host-wide page-serving runtime (core/nodeserver): when set, demand
        # reads / prefetch / completions are multiplexed through the shared
        # per-host engine instead of private threads
        self.server = server
        self._group = None          # FanoutGroup, set by NodePageServer.attach
        # online hotness feedback: when set, demand faults / prefetch hits /
        # guest touches are recorded into the snapshot's HeatMap as
        # TouchEvents carrying this engine as the sequence stream
        self.heat = None
        # cold-extent ordering seam: default policy for start_prefetcher
        self.policy = policy
        self.buffers = buffer_pool or BufferPool(device=instance.image.device)
        self._rdma_arbiter = reader.rdma.arbiter_for(reader.view.host)
        self.link_keys: List[Tuple[object, object]] = []   # (arbiter, key)
        self._inflight: Dict[int, bool] = {}
        self._inflight_lock = threading.Lock()
        self._completion_thread: Optional[threading.Thread] = None
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prefetch_sem: Optional[threading.Semaphore] = None
        self._stop = threading.Event()
        self.prefetch_stats = {"extents_posted": 0, "pages_installed": 0,
                               "doorbells": 0, "extents_skipped": 0}
        # fault handling: bounded retries with seeded backoff, budgeted
        # checksum repair, and breaker-driven degradation
        self.retry = retry_policy or DEFAULT_RETRY_POLICY
        self._retry_rng = random.Random(0x9E37 ^ int(retry_seed))
        self.retry_trace: List[float] = []
        self.repair_budget = 3
        self.repair_stats = {"checksum_mismatches": 0, "checksum_repairs": 0,
                             "quarantined": 0, "rematerialized": 0,
                             "repair_failures": 0,
                             "degraded_preinstalls": 0, "degraded_faults": 0}
        self.degraded_cxl = False
        self.repair_error: Optional[Exception] = None
        # bulk walks (pre_install_hot, install_all_sync's cold walk) that had
        # rows to install, by route: batched into one launch, or per extent
        # and why
        self.walk_routes = {"batched": 0, "per_extent": {
            "injector": 0, "cached_lines": 0, "preverify": 0, "scatter_fn": 0}}
        # the request this session serves (``Orchestrator.restore`` sets it):
        # spans on other threads (the node server's) carry it
        self.req = None

    def _record_heat(self, pages, kind: str) -> None:
        """Typed telemetry: pages in touch order, this restore as the
        sequence stream (feeds the first-touch Markov model)."""
        if self.heat is not None:
            self.heat.record(TouchEvent(pages=pages, kind=kind,
                                        stream=id(self)))

    # -- phase 1: hot-set pre-installation (§3.4) ------------------------------
    HOT_CHUNK_PAGES = 256   # 1 MiB sequential CXL reads over the compact region

    def pre_install_hot(self, use_batch: bool = True,
                        chunk_pages: Optional[int] = None) -> int:
        """uffd.copy the hot set from CXL before resume. Serialized (§5.2).

        Batched mode (default) streams the rank-compacted hot region in
        `chunk_pages` sequential reads and installs each chunk with one
        `uffd_copy_batch` (one scatter call; one uffd.copy ioctl charged per
        guest-contiguous run).  ``use_batch=False`` keeps the strictly
        page-at-a-time path for modeled-time comparison.  Under a node
        server each chunk comes from :meth:`NodePageServer.hot_chunk`:
        co-located restores of one snapshot share one physical read.
        """
        if not use_batch:
            hot = self.reader.hot_page_indices()
            for page in hot:
                kind, off = self.reader.lookup(int(page))
                assert kind == "cxl"
                src = self.reader.cxl_read(off, PAGE_SIZE)
                if self.instance.uffd_copy(int(page), src):
                    self.instance.stats["pre_installed"] += 1
            return int(hot.size)
        ht = self.reader.cxl_health()
        if ht is not None and not ht.allow():
            # CXL host link browned out: skip the bulk pre-install — hot
            # pages demand-fault through the degraded RDMA-only path
            self.degraded_cxl = True
            self.repair_stats["degraded_preinstalls"] += 1
            return 0
        chunk = chunk_pages or self.HOT_CHUNK_PAGES
        n_hot = 0
        with trace.span("serving.hot_walk", cpu=True), self._walk("cxl"):
            for pages, pool_off, nbytes in self.reader.iter_hot_extents(chunk):
                if self.instance.present[pages].all():
                    n_hot += int(pages.size)
                    continue    # already installed (e.g. repeated pre-install)
                with trace.span("serving.extent"):
                    try:
                        if self.server is not None:
                            # hot-chunk fan-out: one CXL read, k scatters (dedup
                            # chunks are content-keyed, so variants share too)
                            raw = self.server.hot_chunk(self, pool_off, nbytes)
                        else:
                            with trace.span("pool.read"):
                                raw = call_with_retries(
                                    lambda o=pool_off, n=nbytes: self.reader.view.read(o, n),
                                    policy=self.retry, rng=self._retry_rng,
                                    ledger=self.ledger, clock=self.clock,
                                    trace=self.retry_trace)
                    except TierFaultError as e:
                        if ht is None:
                            raise
                        ht.record_failure(hard=(e.kind == "brownout"))
                        if not ht.allow():
                            # breaker tripped mid-walk: remaining hot pages take
                            # the degraded demand path instead of failing
                            self.degraded_cxl = True
                            self.repair_stats["degraded_preinstalls"] += 1
                            return n_hot
                        raise
                    if ht is not None:
                        ht.record_success()
                    n_hot += int(pages.size)
                    mat = raw.view(-1, PAGE_SIZE)
                    rows = None
                    if pages.size > 1 and np.any(np.diff(pages) < 0):
                        # dedup extents visit pages in store-offset order: the batch
                        # wants them guest-sorted (one uffd range per guest run), and
                        # the scatter reads the chunk through the permutation
                        rows = np.argsort(pages, kind="stable")
                        pages = pages[rows]
                    with trace.span("serving.queue"):
                        installed = self._install_verified(pages, mat, rows)
                    self.instance.stats["pre_installed"] += installed
        return n_hot

    def drain_degraded_hot(self) -> int:
        """Demand-install the hot pages a degraded pre-install skipped (the
        RDMA-only all-cold path); no-op when the restore was not degraded."""
        if not self.degraded_cxl:
            return 0
        n = 0
        for page in self.reader.hot_page_indices():
            if not self.instance.present[page]:
                self.handle_fault(int(page))
                n += 1
        return n

    # -- checksum repair ----------------------------------------------------
    @staticmethod
    def _is_fault(err: BaseException) -> bool:
        """A recoverable serving fault: injected tier fault or a checksum
        mismatch (any error carrying a structured ``bad_pages`` array)."""
        return (isinstance(err, TierFaultError)
                or getattr(err, "bad_pages", None) is not None)

    def _install_verified(self, pages: np.ndarray, mat: torch.Tensor,
                          rows: Optional[np.ndarray] = None) -> int:
        """Install a batch (page ``pages[i]`` from row ``rows[i]`` of ``mat``,
        default row ``i``); on checksum mismatch, repair instead of abort.

        The bound scatter kernel raises with the guest indices of the bad
        pages; the good subset re-installs immediately and each bad page is
        re-read from its home tier under :attr:`repair_budget`.  Only an
        exhausted budget surfaces the error."""
        pages = np.asarray(pages, dtype=np.int64).reshape(-1)
        try:
            return self.instance.uffd_copy_batch(pages, mat, rows)
        except RuntimeError as err:
            bad = getattr(err, "bad_pages", None)
            if bad is None:
                raise
            return self._repair_batch(pages, mat, bad, rows)

    def _repair_batch(self, pages: np.ndarray, mat: torch.Tensor,
                      bad_pages, rows: Optional[np.ndarray] = None) -> int:
        if rows is None:
            mat = mat.reshape(pages.size, PAGE_SIZE)
            rows = np.arange(pages.size, dtype=np.int64)
        bad = {int(p) for p in np.atleast_1d(np.asarray(bad_pages))}
        self.repair_stats["checksum_mismatches"] += len(bad)
        good = np.array([i for i, p in enumerate(pages) if int(p) not in bad],
                        dtype=np.int64)
        n = 0
        if good.size:
            n += self.instance.uffd_copy_batch(pages[good], mat, rows[good])
        for p in sorted(bad):
            n += self._repair_page(int(p))
        return n

    def _reread_home(self, page: int, kind: str, off: int) -> torch.Tensor:
        """Budgeted re-read from the page's home tier, charged like a fresh
        demand read (repair is not free).  The CXL re-read goes through the
        owner-path tier read, bypassing the host line cache (which may hold
        the poisoned line)."""
        if kind == "cxl":
            row = self.reader.view.tier.read(off, PAGE_SIZE)
            self.ledger.add("cxl_read",
                            self.reader.view.arbiter.charge(PAGE_SIZE))
            return row
        if kind == "rdma_z":
            pool_off, nbytes, raw = self.reader.cold_extent(off)
            payload = self.reader.rdma.read(pool_off, nbytes)
            self.ledger.add("rdma_read", self._rdma_arbiter.charge(nbytes))
            return self.reader.decompress_page(payload, raw)
        row = self.reader.rdma.read(off, PAGE_SIZE)
        self.ledger.add("rdma_read", self._rdma_arbiter.charge(PAGE_SIZE))
        return row

    def _repair_page(self, page: int) -> int:
        """Re-read one checksum-bad page from its home tier until it
        verifies, quarantining a persistently-bad shared dedup offset so no
        new snapshot rides it, then re-materializing it once a clean copy is
        in hand; an exhausted budget raises the last error."""
        kind, off = self.reader.lookup(page)
        store = None
        if self.reader.regions.dedup and kind in ("cxl", "rdma"):
            tier = self.reader.view.tier if kind == "cxl" else self.reader.rdma
            store = getattr(tier, "dedup_store", None)
        quarantined = False
        last_err: Optional[Exception] = None
        for _attempt in range(self.repair_budget):
            try:
                row = self._reread_home(page, kind, off)
            except TierFaultError as e:
                last_err = e
                continue
            try:
                n = self.instance.uffd_copy_batch(
                    np.array([page], dtype=np.int64), row)
            except RuntimeError as err:
                if getattr(err, "bad_pages", None) is None:
                    raise
                last_err = err
                if store is not None and not quarantined:
                    # the shared store offset itself is corrupt: bar it from
                    # new sharing before anyone else rides it (refcounts are
                    # untouched, so invariant I6 holds)
                    quarantined = store.quarantine(off)
                    if quarantined:
                        self.repair_stats["quarantined"] += 1
                continue
            self.repair_stats["checksum_repairs"] += 1
            if quarantined:
                # this re-read verified clean: scrub the store offset and
                # put it back into circulation
                store.rematerialize(off, row)
                self.repair_stats["rematerialized"] += 1
            return n
        self.repair_stats["repair_failures"] += 1
        self.repair_error = last_err
        raise last_err  # exhausted repair budget: surface the error

    def _degraded_cxl_fault(self, page: int, off: int) -> None:
        """Serve a hot-page demand fault while the CXL breaker is open: the
        bytes come over the RDMA fabric instead of failing."""
        data = self.reader.degraded_cxl_read(off, PAGE_SIZE)
        self.repair_stats["degraded_faults"] += 1
        self._install_verified(np.array([page], dtype=np.int64), data)

    def install_zero_runs(self) -> int:
        """uffd.zeropage the zero runs (one ioctl per run), all of them under
        one lock acquisition."""
        with trace.span("serving.zero_runs"):
            k = self.instance.uffd_zeropage_runs(self.reader.zero_runs())
            trace.count("serving.zero_pages", k)
        return k

    # -- phase 2: demand faults -------------------------------------------------
    def start_completion_handler(self) -> None:
        if self.rdma_engine is None:
            return
        self._completion_thread = threading.Thread(target=self._completion_loop, daemon=True)
        self._completion_thread.start()

    def start_prefetcher(self, policy: Optional[PrefetchPolicy] = None) -> None:
        """Background cold-extent prefetch in ``policy`` order (default: the
        engine's policy, else
        :class:`~repro_torch.core.prefetch_model.LayoutOrderPolicy`).  Demand
        faults for pages not yet in flight still take priority on the RDMA
        engine's submit queue.

        Under a node server the extents are enqueued ONCE per fan-out group
        on the host-wide pump, which drains them round-robin across all
        co-located restores instead of spawning a private thread."""
        policy = resolve_policy(policy if policy is not None else self.policy)
        if self.server is not None:
            self.server.enqueue_prefetch(self, policy=policy)
            return
        if self.rdma_engine is None or self._prefetch_thread is not None:
            return
        inflight = max(1, self.rdma_engine.tier.cost.max_inflight)
        self._prefetch_sem = threading.Semaphore(inflight)
        self._prefetch_thread = threading.Thread(
            target=self._prefetch_loop, args=(policy,), daemon=True)
        self._prefetch_thread.start()

    def stop(self) -> None:
        """Stop serving and leave no residue: in-flight completions are
        drained (their demand-read buffers go back to the BufferPool, their
        pages install normally) and stale ``_inflight`` entries are cleared.
        Node-server sessions detach from the shared runtime instead."""
        self._stop.set()
        if self.heat is not None:
            self.heat.end_stream(id(self))
        if self.server is not None:
            self.server.detach(self)
            self._unregister_links()
            return
        if self._prefetch_thread is not None:
            self._prefetch_thread.join(timeout=1.0)
        if self.rdma_engine is not None:
            # let already-posted reads execute so their buffers come back
            self.rdma_engine.quiesce()
        if self._completion_thread is not None:
            self._completion_thread.join(timeout=1.0)
        if self.rdma_engine is not None:
            while True:
                item = self.rdma_engine.poll_completion(block=False)
                if item is None:
                    break
                self._install_completion(*item)
        with self._inflight_lock:
            self._inflight.clear()
        self._unregister_links()

    def _unregister_links(self) -> None:
        for arbiter, key in self.link_keys:
            arbiter.unregister(key)
        self.link_keys = []

    def handle_fault(self, page: int) -> None:
        """userfaultfd fault for `page`; never blocks on RDMA (§3.4)."""
        if self.instance.present[page]:
            trace.count("serving.fault_joined")
            return
        kind, off = self.reader.lookup(page)
        if kind == "zero":
            self.instance.stats["fault_zero"] += 1
            self.instance.uffd_zeropage(page)
            return
        if kind == "cxl":
            self.instance.stats["fault_cxl"] += 1
            self._record_heat([page], "touch")
            ht = self.reader.cxl_health()
            if ht is not None and not ht.allow():
                self._degraded_cxl_fault(page, off)
                return
            try:
                src = call_with_retries(
                    lambda: self.reader.view.read(off, PAGE_SIZE),
                    policy=self.retry, rng=self._retry_rng,
                    ledger=self.ledger, clock=self.clock, urgent=True,
                    trace=self.retry_trace)
            except TierFaultError as e:
                if ht is None:
                    raise
                # a blocked guest vCPU cannot wait out the link: record the
                # failure and serve the page over RDMA right now
                ht.record_failure(hard=(e.kind == "brownout"))
                self._degraded_cxl_fault(page, off)
                return
            if ht is not None:
                ht.record_success()
            self._install_verified(np.array([page], dtype=np.int64), src)
            return
        # cold page → async RDMA read (zstd per page on a compressed tier)
        self.instance.stats["fault_rdma"] += 1
        if kind == "rdma_z":
            pool_off, nbytes, raw = self.reader.cold_extent(off)
        else:
            pool_off, nbytes, raw = off, PAGE_SIZE, True
        if self.rdma_engine is None and self.server is None:
            self._record_heat([page], "demand_fault")
            payload = call_with_retries(
                lambda: self.reader.rdma.read(pool_off, nbytes),
                policy=self.retry, rng=self._retry_rng,
                ledger=self.ledger, clock=self.clock, urgent=True,
                trace=self.retry_trace)
            self.ledger.add("rdma_read", self._rdma_arbiter.charge(nbytes))
            self._install_verified(
                np.array([page], dtype=np.int64),
                self.reader.decompress_page(payload, raw)
                if kind == "rdma_z" else payload)
            return
        with self._inflight_lock:
            covered = bool(self._inflight.get(page))
            if not covered:
                self._inflight[page] = True
        # a fault landing on an in-flight prefetch extent is a prefetch hit
        self._record_heat([page],
                          "prefetch_hit" if covered else "demand_fault")
        if covered:
            trace.count("serving.fault_joined")
            return     # already in flight (demand or prefetch extent)
        buf = self.buffers.acquire()
        if self.server is not None:
            self.server.submit_demand(self, pool_off, nbytes, buf,
                                      (page, nbytes, raw, kind))
        else:
            self.rdma_engine.submit_read(pool_off, nbytes, buf,
                                         ("page", page, nbytes, raw, kind),
                                         urgent=True)

    def access(self, page: int, timeout_s: float = 30.0) -> None:
        """Guest touch: fault if needed and wait for install (test/replay API)."""
        if self.instance.present[page]:
            self._record_heat([page], "touch")
            return
        with trace.span("serving.fault"):
            self.handle_fault(page)
            if not self.instance.wait_present(page, timeout_s):
                raise TimeoutError(f"page {page} not installed within {timeout_s}s")

    def touch_pages(self, pages, timeout_s: float = 30.0) -> Dict[str, int]:
        """Replay one invocation's guest touches (batch form of :meth:`access`).
        Returns {"present": ..., "faulted": ...}."""
        pages = np.asarray(pages, dtype=np.int64).reshape(-1)
        if pages.size == 0:
            return {"present": 0, "faulted": 0}
        present_mask = self.instance.present[pages]
        hit = pages[present_mask]
        if hit.size:
            self._record_heat(hit, "touch")
        missing = pages[~present_mask]
        for p in missing:
            if not self.instance.present[p]:
                self.handle_fault(int(p))
        for p in missing:
            if not self.instance.wait_present(int(p), timeout_s):
                raise TimeoutError(f"page {int(p)} not installed within {timeout_s}s")
        return {"present": int(present_mask.sum()), "faulted": int(missing.size)}

    def _install_completion(self, buf: torch.Tensor, token, t_done: int = 0,
                            req=None) -> None:
        trace.add("rdma.cq_wait", t_done, trace.now(), req)
        if token[0] == "extent":
            _tag, start, n, rank0 = token
            try:
                mat = self.reader.split_cold_extent(rank0, n, buf)
                k = self._install_verified(np.arange(start, start + n), mat)
                self.prefetch_stats["pages_installed"] += k
            except RuntimeError as e:
                # completion-thread context: an exhausted repair budget
                # cannot raise into the guest — record it (waiters observe
                # the absent page via ``repair_error``)
                if not self._is_fault(e):
                    raise
                self.repair_error = e
            finally:
                with self._inflight_lock:
                    for p in range(start, start + n):
                        self._inflight.pop(p, None)
                if self._prefetch_sem is not None:
                    self._prefetch_sem.release()
            return
        _tag, page, nbytes, raw, kind = token
        try:
            data = (self.reader.decompress_page(buf[:nbytes], raw)
                    if kind == "rdma_z" else buf[:PAGE_SIZE])
            self._install_verified(np.array([int(page)], dtype=np.int64), data)
        except RuntimeError as e:
            if not self._is_fault(e):
                raise
            self.repair_error = e
        finally:
            self.buffers.release(buf)
            with self._inflight_lock:
                self._inflight.pop(int(page), None)

    def _completion_loop(self) -> None:
        eng = self.rdma_engine
        assert eng is not None
        while not self._stop.is_set():
            item = eng.poll_completion(block=True)
            if item is None:
                continue
            while item is not None:
                self._install_completion(*item)
                # hybrid poll: batch further completions without sleeping
                polled = None
                for _ in range(eng.poll_budget):
                    polled = eng.poll_completion(block=False)
                    if polled is not None:
                        eng.stats["busy_polls"] += 1
                        break
                item = polled

    # -- cold extent prefetcher (§3.4) ------------------------------------------
    def _prefetch_loop(self, policy: PrefetchPolicy) -> None:
        eng = self.rdma_engine
        assert eng is not None and self._prefetch_sem is not None
        cost = eng.tier.cost
        pending_bytes, pending_ops = 0, 0

        def flush_doorbell():
            nonlocal pending_bytes, pending_ops
            if pending_ops:
                # doorbell-batched posts: op latencies overlap up to QP depth
                self.ledger.add("rdma_prefetch",
                                eng.arbiter.charge_pipelined(pending_bytes, pending_ops))
                self.prefetch_stats["doorbells"] += 1
                pending_bytes, pending_ops = 0, 0

        for es, en, rank0, pool_off, nbytes in policy.order_extents(self, None):
            if self._stop.is_set():
                flush_doorbell()
                return
            if self.instance.present[es : es + en].all():
                self.prefetch_stats["extents_skipped"] += 1
                continue
            while not self._prefetch_sem.acquire(timeout=0.05):
                if self._stop.is_set():
                    flush_doorbell()
                    return
            # mark in flight only once a QP slot is held: demand faults on
            # these pages keep their urgent-read path while the extent is
            # still waiting for a slot
            with self._inflight_lock:
                for p in range(es, es + en):
                    self._inflight.setdefault(p, True)
            pending_bytes += nbytes
            pending_ops += 1
            if pending_ops >= cost.max_inflight:
                flush_doorbell()
            buf = torch.empty(nbytes, dtype=torch.uint8, device=eng.tier.device)
            eng.submit_read(pool_off, nbytes, buf, ("extent", es, en, rank0),
                            urgent=False, charge=False)
            self.prefetch_stats["extents_posted"] += 1
        flush_doorbell()

    def wait_prefetch_idle(self, timeout_s: float = 30.0) -> bool:
        """Block until the prefetch walk posted everything and all cold pages
        are installed: ONE condition-variable wait on a predicate over the
        `present` bitmap sliced by the cold page index."""
        if self.server is not None:
            if self._group is None or not self._group.enqueued:
                return True
        elif self._prefetch_thread is None:
            return True
        else:
            self._prefetch_thread.join(timeout=timeout_s)
            if self._prefetch_thread.is_alive():
                return False
        cold = self.reader.cold_page_indices()
        if cold.size == 0:
            return True
        present = self.instance.present
        with self.instance._cv:
            return self.instance.clock.cv_wait_for(
                self.instance._cv, lambda: bool(present[cold].all()), timeout_s)

    # -- bulk restore ----------------------------------------------------------
    def install_all_sync(self, use_batch: bool = True) -> None:
        if not use_batch:
            for page in range(self.instance.image.total_pages):
                if not self.instance.present[page]:
                    kind, off = self.reader.lookup(page)
                    if kind == "zero":
                        self.instance.uffd_zeropage(page)
                    elif kind == "cxl":
                        self.instance.uffd_copy(page, self.reader.cxl_read(off, PAGE_SIZE))
                    else:
                        nbytes = (self.reader.cold_extent(off)[1]
                                  if kind == "rdma_z" else PAGE_SIZE)
                        self.ledger.add("rdma_read", self._rdma_arbiter.charge(nbytes))
                        self.instance.uffd_copy(page, self.reader.read_page(page))
            return
        self.install_zero_runs()
        self.pre_install_hot()
        self.drain_degraded_hot()
        # extents contiguous in guest and tier: the private layout's cold
        # runs in guest order; a dedup snapshot's runs, split where store
        # offsets stop being adjacent, largest run first (the order the
        # reference walks them in, which the ledger's sums follow).  A
        # batched walk over a raw tier queues the arena's rows unread; any
        # other reads each extent
        with trace.span("serving.cold_walk", cpu=True), self._walk("rdma") as rows:
            if rows is not None and not self.reader.regions.cold_compressed:
                self._queue_cold_rows(*rows)
            else:
                self._cold_walk_per_extent()

    def _cold_walk_per_extent(self) -> None:
        """The cold walk extent by extent, as the reference walks it: each
        extent read (and decompressed, for a compressed tier), charged and
        installed or queued."""
        for es, en, rank0, pool_off, nbytes in self.reader.iter_cold_extents(
                max_extent_pages=1 << 30, largest_first=self.reader.regions.dedup):
            with trace.span("serving.extent"):
                with trace.span("pool.read"):
                    payload = call_with_retries(
                        lambda o=pool_off, b=nbytes: self.reader.rdma.read(o, b),
                        policy=self.retry, rng=self._retry_rng,
                        ledger=self.ledger, clock=self.clock,
                        trace=self.retry_trace)
                self.ledger.add("rdma_read", self._rdma_arbiter.charge(nbytes))
                mat = self.reader.split_cold_extent(rank0, en, payload)
                with trace.span("serving.queue"):
                    self._install_verified(np.arange(es, es + en), mat)

    def _queue_cold_rows(self, pages: np.ndarray, offs: np.ndarray) -> None:
        """The batched cold walk over a raw RDMA tier: every extent's rows
        queued straight from the tier's arena, unread, and each extent
        charged and accounted as the per-extent walk charges it (its
        ``rdma_read``, then its batch), in the same order."""
        with trace.span("serving.cold_rows"):
            pages, offs, bounds = self.reader.cold_walk_extents(pages, offs)
            self.ledger.add_each("rdma_read",
                                 self._rdma_arbiter.charges(np.diff(bounds) * PAGE_SIZE))
            n = self.instance.queue_extents(self.reader.rdma.page_rows(),
                                            offs // PAGE_SIZE, pages, bounds)
            trace.count("serving.arena_rows", n)

    # -- route of a bulk walk ---------------------------------------------------
    @contextlib.contextmanager
    def _walk(self, tier: str):
        """The context one bulk walk over ``tier``'s rows ("cxl": the hot
        pre-install, "rdma": the cold walk) runs in; it gives the walk's
        ``(pages, pool_offs)`` (:meth:`SnapshotReader.walk_rows`) when the
        walk is batched, else None.

        A walk is batched — each extent's rows queued, all of them
        installed by one launch at its end — when nothing in it can observe
        the deferral; the choice is made before the walk touches any state,
        and a walk that is not batched runs per extent exactly as before.
        Walks with no page left to install are not counted."""
        with trace.span("serving.walk_route"):
            pages, offs = self.reader.walk_rows(tier)
            todo = ~self.instance.present[pages]
            idle = not todo.any()
            reason = None if idle else self._per_extent_reason(tier, pages[todo], offs[todo])
        if reason is not None:
            self.walk_routes["per_extent"][reason] += 1
        if idle or reason is not None:
            yield None
            return
        self.walk_routes["batched"] += 1
        batched = (self.instance.scatter_fn or page_scatter).scatter_rows

        def launch(dest: torch.Tensor, segments) -> None:
            try:
                batched(dest, segments)
            except RuntimeError as err:
                bad = getattr(err, "bad_pages", None)
                if bad is None:
                    raise
                self._repair_flush(segments, bad)

        with self.instance.queued_installs(launch):
            yield pages, offs

    def _repair_flush(self, segments, bad_pages) -> None:
        """A batched walk's launch found rows that disagree with their
        checksums (the pre-verify passed, so the bytes changed after it):
        each queued batch (an extent) holding a bad page takes the
        reference's repair path — its queued accounting is taken back, its
        good rows install and each bad page is re-read from its home tier
        under ``repair_budget``.  The other batches were installed by the
        launch; the flush marks them present.  The repair's charges land
        after the walk's, not between its extents: the same charges, summed
        in another order."""
        bad = np.asarray(bad_pages, dtype=np.int64)
        inst = self.instance
        scatter = inst.scatter_fn or page_scatter
        with inst.direct_installs():
            for seg in segments:
                mat, src, sel = seg
                hit = np.isin(sel, bad)
                if not hit.any():
                    continue
                rows = src if src is not None else np.arange(sel.size, dtype=np.int64)
                for lo, hi in seg.batches():
                    if not hit[lo:hi].any():
                        continue
                    part = sel[lo:hi]
                    inst.unaccount_batch(scatter, part)
                    self._repair_batch(part, mat, part[hit[lo:hi]], rows[lo:hi])

    def _per_extent_reason(self, tier: str, pages: np.ndarray,
                           offs: np.ndarray) -> Optional[str]:
        """Why the walk over ``pages`` (read at pool ``offs``) must run per
        extent, or None when it can be batched:

        * ``injector`` — a fault injector is armed on a tier, or a tier is a
          proxy whose reads inject faults (``injects_faults``, the
          simulator's ``FlakyTier``), so a read could fail, retry, sleep or
          be poisoned;
        * ``scatter_fn`` — the scatter function has no batched form;
        * ``cached_lines`` — (verified walks) a valid HostView line overlaps
          the CXL source rows, so a read may return other bytes than the
          arena holds;
        * ``preverify`` — (verified walks) one verify-only launch over the
          source rows, straight from the tier arena, found a mismatch: the
          walk takes the reference's repair path.
        """
        if any(getattr(t, "fault_injector", None) is not None
               or getattr(t, "injects_faults", False)
               for t in (self.reader.view.tier, self.reader.rdma)):
            return "injector"
        scatter = self.instance.scatter_fn or page_scatter
        if getattr(scatter, "scatter_rows", None) is None:
            return "scatter_fn"
        if getattr(scatter, "expected", None) is None:
            return None                                  # unverified walk
        if tier == "rdma" and self.reader.regions.cold_compressed:
            # the rows are decompressed on the host during the walk: no arena
            # row to pre-verify; the flush's launch verifies them
            return None
        if tier == "cxl" and self.reader.view.has_valid_lines(offs, PAGE_SIZE):
            return "cached_lines"
        arena = (self.reader.view.tier if tier == "cxl" else self.reader.rdma).page_rows()
        if not scatter.verify_rows([(arena, offs // PAGE_SIZE, pages)]):
            return "preverify"
        return None


# The restore engine IS the paper's per-instance "restore session"; the
# simulator and some call sites use that name.
RestoreSession = RestoreEngine


def mmap_install_cost(pages: Sequence[int]) -> float:
    """Modeled cost of installing `pages` via per-range mmap (the rejected
    alternative, §2.3.4): one mmap syscall per contiguous run plus a per-page
    cost 2.6x that of uffd.copy."""
    runs = runs_from_pages(pages)
    return sum(n * MMAP_PER_PAGE_S for _, n in runs) + len(runs) * MMAP_SYSCALL_S
