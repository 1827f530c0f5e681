"""Aquifer core on PyTorch: the publish→restore main path on one host.

- :mod:`pagestore`  — paged flat address space over a device byte buffer
- :mod:`pool`       — two-tier pool on device arenas, cost models, incoherent
  host views with a vectorized line cache
- :mod:`snapshot`   — hotness-based compact snapshot format, private layout (§3.2)
- :mod:`serving`    — copy-based page serving, async RDMA demand paging (§3.4)
- :mod:`profiler`   — TouchEvent telemetry and decayed heat maps
- :mod:`prefetch_model` — learned first-touch ordering behind PrefetchPolicy
- :mod:`faults`     — deterministic fault injection, retry policy, tier health

Coherence, pool master, node server, orchestrator, dedup and re-curation
are not ported yet (ROADMAP §A).
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
    pages_from_runs,
    resolve_device,
    runs_from_pages,
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
    SnapshotReader,
    SnapshotRegions,
    build_snapshot,
    classify_pages,
    decode_slot,
    encode_slot,
    estimate_snapshot_cxl_size,
    free_snapshot,
    reconstruct_image,
    runs_of_indices,
)
from .serving import AsyncRDMAEngine, BufferPool, Instance, RestoreEngine
from .profiler import RUN_PAGES, START_RUN, HeatMap, HeatRegistry, TouchEvent
from .prefetch_model import (
    LayoutOrderPolicy,
    PredictedOrderPolicy,
    PrefetchModel,
    PrefetchPolicy,
    fit_prefetch_model,
    resolve_policy,
)

__all__ = [k for k in dir() if not k.startswith("_")]
