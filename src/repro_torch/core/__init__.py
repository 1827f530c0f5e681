"""Aquifer core on PyTorch: the publish→restore path and the pod control plane.

- :mod:`pagestore`  — paged flat address space over a device byte buffer
- :mod:`pool`       — two-tier pool on device arenas, cost models, incoherent
  host views with a vectorized line cache
- :mod:`snapshot`   — hotness-based compact snapshot format, private and
  content-addressed layouts (§3.2, §3.6)
- :mod:`dedup`      — content-addressed, refcounted page stores (§3.6)
- :mod:`serving`    — copy-based page serving, async RDMA demand paging (§3.4)
- :mod:`profiler`   — offline hotness profiling (AccessRecorder) and online
  TouchEvent telemetry with decayed heat maps
- :mod:`prefetch_model` — learned first-touch ordering behind PrefetchPolicy
- :mod:`faults`     — deterministic fault injection, retry policy, tier health
- :mod:`coherence`  — ownership-based coherence protocol (§3.3)
- :mod:`master`     — pool master: publish/update/delete, eviction (§3.6)
- :mod:`nodeserver` — host-wide page-serving runtime: shared RDMA engine,
  cross-instance DRR prefetch + doorbell batching, hot-chunk fan-out (§3.5)
- :mod:`orchestrator` — node agent: borrow → flush → pre-install → resume
- :mod:`failover`   — pool-master heartbeat lease and election (§3.6)

The private layout's cold tier may be zstd-compressed per page
(``compress_cold``; decompressed on the host, uncompressed without the
``zstandard`` package).
"""
from .clock import REAL_CLOCK, Clock, RealClock
from .faults import (
    DEFAULT_RETRY_POLICY,
    FaultInjector,
    RetryPolicy,
    TierFaultError,
    TierHealth,
    call_with_retries,
)
from .pagestore import (
    PAGE_SIZE,
    ArrayExtent,
    Manifest,
    StateImage,
    kernel_zero_scan,
    pages_from_runs,
    resolve_device,
    runs_from_pages,
    set_zero_scan_backend,
)
from .pool import (
    CXL_COST,
    RDMA_COST,
    TIER_CXL,
    TIER_RDMA,
    AllocError,
    CostModel,
    CXLBudget,
    HierarchicalPool,
    HostView,
    LinkArbiter,
    MemoryTier,
    TimeLedger,
)
from .snapshot import (
    ZERO_SENTINEL,
    PageClasses,
    RecurationPlan,
    SnapshotReader,
    SnapshotRegions,
    build_snapshot,
    classify_pages,
    decode_dedup_offsets,
    decode_slot,
    encode_slot,
    estimate_snapshot_cxl_size,
    exclusive_cxl_bytes,
    free_snapshot,
    plan_recuration,
    reconstruct_image,
    runs_of_indices,
)
from .dedup import (
    FNV_OFFSET,
    FNV_PRIME,
    DedupStore,
    fnv1a_page,
    fnv1a_pages,
    poly32_hash_fn,
)
from .serving import (
    AsyncRDMAEngine,
    BufferPool,
    Instance,
    RestoreEngine,
    RestoreSession,
    mmap_install_cost,
)
from .coherence import (
    STATE_FREE,
    STATE_PUBLISHED,
    STATE_TOMBSTONE,
    AtomicU64,
    Borrow,
    Catalog,
    CatalogEntry,
    LeaseFallback,
)
from .master import CXLCapacityManager, PoolMaster
from .nodeserver import FanoutGroup, HotChunkCache, NodePageServer
from .orchestrator import Orchestrator, RestoredInstance
from .profiler import (
    RUN_PAGES,
    START_RUN,
    AccessRecorder,
    HeatMap,
    HeatRegistry,
    TouchEvent,
    WorkloadProfile,
    profile_invocations,
)
from .prefetch_model import (
    LayoutOrderPolicy,
    PredictedOrderPolicy,
    PrefetchModel,
    PrefetchPolicy,
    fit_prefetch_model,
    resolve_policy,
)

__all__ = [k for k in dir() if not k.startswith("_")]
