"""Node-side orchestrator (§3.1): MicroVM lifecycle on one server host.

Each orchestrator owns a host-private (incoherent) view of the CXL tier and
restores instances by: borrow → clflushopt the snapshot's CXL sections →
load machine state → pre-install hot set → resume, with cold pages
demand-paged asynchronously from RDMA.  Falls back to cold start when the
borrow CAS fails (§3.3).

Restores are served through the host-wide :class:`NodePageServer` by
default — one shared RDMA engine / completion worker / prefetch pump per
host, with hot-chunk fan-out across same-snapshot restores.
``scatter_fn`` accepts any ``ScatterFn`` — the default ``page_scatter``
kernel, or the fused gather→verify→scatter kernel
(``kernels/snapshot_fuse.FusedScatter``); the fused form is additionally
bound per restore to the snapshot's publish-time checksum table, so
pre-install and fan-out installs verify content as they land.  The restored
image lives on the pool's device.
``use_node_server=False`` keeps the legacy per-instance engine path (one
private engine + completion thread per restore) for A/B comparison; that
path registers each restore as its own stream on the host's link arbiters
so its modeled time is contention-aware too.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Optional

from . import trace
from .coherence import Borrow, Catalog
from .nodeserver import NodePageServer
from .pagestore import StateImage
from .pool import HierarchicalPool, TimeLedger
from .prefetch_model import PrefetchPolicy, resolve_policy
from .serving import AsyncRDMAEngine, BufferPool, Instance, RestoreEngine
from .snapshot import SnapshotReader

# request ids, one a restore, shared by every span of its cold start
_REQUESTS = itertools.count(1)


@dataclasses.dataclass
class RestoredInstance:
    """A restored microVM instance plus the borrow pinning its snapshot."""

    name: str
    instance: Instance
    engine: RestoreEngine
    borrow: Borrow
    ledger: TimeLedger
    cold_start: bool = False

    def shutdown(self) -> None:
        with trace.span("serving.release"):
            self.engine.stop()
            if self.engine.rdma_engine is not None:
                self.engine.rdma_engine.close()
            self.borrow.release()


class Orchestrator:
    """One per server node; connected to the pod's shared pool + catalog."""

    def __init__(
        self,
        host: str,
        pool: HierarchicalPool,
        catalog: Catalog,
        use_async_rdma: bool = True,
        buffer_pool_pages: int = 256,
        prefetch_cold: bool = False,
        scatter_fn=None,
        node_server: Optional[NodePageServer] = None,
        use_node_server: bool = True,
        heat=None,
        prefetch_policy: Optional[PrefetchPolicy] = None,
    ):
        self.host = host
        self.pool = pool
        self.catalog = catalog
        # online hotness feedback: pod-shared HeatRegistry; every restore's
        # demand-fault / prefetch-hit / touch telemetry lands there keyed by
        # the borrowed (name, version)
        self.heat = heat
        self.use_async_rdma = use_async_rdma
        self.buffer_pool_pages = buffer_pool_pages
        self.prefetch_cold = prefetch_cold
        # cold-extent ordering seam (default LayoutOrderPolicy)
        self.prefetch_policy = resolve_policy(prefetch_policy)
        self.scatter_fn = scatter_fn
        self.node_server = node_server
        self.use_node_server = bool(use_node_server) and use_async_rdma
        self._owned_server: Optional[NodePageServer] = None
        self.stats = {"warm_restores": 0, "cold_starts": 0}
        self._lock = threading.Lock()

    def _get_server(self) -> NodePageServer:
        if self.node_server is not None:
            return self.node_server
        with self._lock:
            if self._owned_server is None:
                self._owned_server = NodePageServer(
                    self.host, self.pool,
                    buffer_pool_pages=self.buffer_pool_pages,
                    heat=self.heat)
            return self._owned_server

    def close(self) -> None:
        """Park the owned node server (its threads auto-park when the last
        session detaches, so this is belt-and-braces for early teardown)."""
        with self._lock:
            srv, self._owned_server = self._owned_server, None
        if srv is not None:
            srv.close()

    def restore(self, name: str, pre_install: bool = True,
                prefetch_cold: Optional[bool] = None,
                prefetch_policy: Optional[PrefetchPolicy] = None,
                ) -> Optional[RestoredInstance]:
        """Warm-restore an instance from the pool; None ⇒ caller cold-boots.

        The hot set is pre-installed run-at-a-time (one CXL read + one
        uffd.copy ioctl per contiguous run); with ``prefetch_cold`` the cold
        extents are additionally streamed in the background in
        ``prefetch_policy`` order (default: the orchestrator's policy, i.e.
        snapshot layout) while demand faults retain priority (§3.4).

        Each call is a new request: its id (:data:`trace.REQ`, and the
        engine's ``req``) marks every span of this cold start."""
        req = next(_REQUESTS)
        trace.REQ.set(req)
        with trace.span("restore", req):
            return self._restore(name, req, pre_install, prefetch_cold, prefetch_policy)

    def _restore(self, name: str, req: int, pre_install: bool, prefetch_cold: Optional[bool],
                 prefetch_policy: Optional[PrefetchPolicy]) -> Optional[RestoredInstance]:
        with trace.span("restore.borrow"):
            borrow = self.catalog.borrow(name)
        if borrow is None or borrow.regions is None:
            with self._lock:
                self.stats["cold_starts"] += 1
            return None

        ledger = TimeLedger()
        view = self.pool.host_view(self.host, ledger)
        reader = SnapshotReader(borrow.regions, view, self.pool.rdma)
        # §3.3: after a successful borrow, invalidate potentially-stale lines
        with trace.span("restore.invalidate"):
            reader.invalidate_cxl()
        with trace.span("restore.machine_state"):
            manifest, _meta = reader.machine_state()

        with trace.span("restore.instance"):
            instance = Instance(StateImage.empty_like(manifest, device=self.pool.device),
                                ledger, clock=self.pool.clock)
        if self.use_node_server:
            with trace.span("nodeserver.attach"):
                engine = self._get_server().attach(
                    name, borrow.regions.version, reader, instance,
                    scatter_fn=self.scatter_fn)
        else:
            rdma_engine = (
                AsyncRDMAEngine(self.pool.rdma, ledger, host=self.host)
                if self.use_async_rdma else None
            )
            engine = RestoreEngine(
                reader, instance, rdma_engine,
                BufferPool(self.buffer_pool_pages, device=self.pool.device),
                scatter_fn=self.scatter_fn,
            )
            if self.heat is not None:
                hm = self.heat.map_for(name, borrow.regions.version,
                                       instance.image.total_pages)
                hm.note_restore()
                engine.heat = hm
            # A/B honesty: a private-engine restore is still one stream on
            # the host's CXL link and RNIC — register it so its modeled
            # time sees the same contention the shared runtime sees
            key = ("restore", id(engine))
            for tier in (self.pool.cxl, self.pool.rdma):
                arbiter = tier.arbiter_for(self.host)
                arbiter.register(key)
                engine.link_keys.append((arbiter, key))
        engine.req = req
        try:
            if pre_install:
                engine.pre_install_hot()
            engine.start_completion_handler()
            do_prefetch = (self.prefetch_cold if prefetch_cold is None
                           else prefetch_cold)
            if do_prefetch:
                engine.start_prefetcher(
                    policy=prefetch_policy or self.prefetch_policy)
        except BaseException:
            # failed restore (e.g. a fused-scatter checksum mismatch during
            # pre-install) must not leak the engine session or the borrow
            engine.stop()
            if engine.rdma_engine is not None:
                engine.rdma_engine.close()
            borrow.release()
            raise
        with self._lock:
            self.stats["warm_restores"] += 1
        return RestoredInstance(name, instance, engine, borrow, ledger)
