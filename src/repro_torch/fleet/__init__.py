"""Traffic-driven fleet serving: seeded arrival synthesis, locality-aware
placement over the CXL pod, keep-warm economics, and queue-depth host
autoscaling — the serving layer that turns single-restore machinery
(PoolMaster publish, NodePageServer fan-out, dedup overlap) into modeled
fleet-scale cold-start numbers.

Host arithmetic on numpy, as in the JAX package: the same seed gives the
same traces, profiles, placements and result arrays.  Only
:func:`profile_reader` touches the pool, through the port's
``SnapshotReader``."""
from .arrivals import (
    FunctionType,
    Trace,
    diurnal_arrivals,
    generate_trace,
    onoff_arrivals,
    poisson_arrivals,
    synthesize_fleet,
    zipf_rates,
)
from .autoscale import QueueAutoscaler
from .driver import (
    MODE_COLD,
    MODE_JOIN,
    MODE_WARM,
    FleetDriver,
    FleetResult,
)
from .model import RestoreProfile, profile_reader
from .placement import POLICIES, HostState, PlacementScheduler
from .topology import (
    FleetTopology,
    plan_balanced,
    plan_replicated,
    plan_single,
)

__all__ = [
    "FunctionType", "Trace", "poisson_arrivals", "diurnal_arrivals",
    "onoff_arrivals", "zipf_rates", "synthesize_fleet", "generate_trace",
    "RestoreProfile", "profile_reader",
    "HostState", "PlacementScheduler", "POLICIES",
    "QueueAutoscaler",
    "FleetDriver", "FleetResult", "MODE_COLD", "MODE_JOIN", "MODE_WARM",
    "FleetTopology", "plan_single", "plan_balanced", "plan_replicated",
]
