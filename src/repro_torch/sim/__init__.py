"""Deterministic multi-host cluster simulator (test infrastructure).

Drives the *real* production objects — ``Catalog``/``LeaseFallback``,
``PoolMaster``, ``FailoverNode``, ``HierarchicalPool``, ``RestoreSession`` —
across N simulated hosts sharing one MHD catalog, under:

* a :class:`VirtualClock` injected through :mod:`repro_torch.core.clock`, so
  timeouts / lease expiries / drain waits are simulated time, not wall time;
* a seeded interleaving scheduler (:class:`SimCluster`) that serializes host
  "steps", so any failure replays exactly from its seed;
* a fault-injection layer (:mod:`repro_torch.sim.faults`): host crash mid-borrow,
  owner crash between tombstone and republish, lease expiry during GC,
  RDMA extent timeout/retry;
* an invariant checker (:mod:`repro_torch.sim.invariants`) run after every step.

Page bytes live on ``SimCluster(device=...)`` (default ``"cuda"``; the
kernels on a CUDA device, their plain versions on ``"cpu"``); scheduling,
traces and accounting are host state, so a seed gives the same trace on
either.  See DESIGN.md §9 for the architecture and the invariant list.
"""
from .clock import VirtualClock
from .faults import FaultPlan, FlakyTier, SimTimeout
from .invariants import InvariantChecker, InvariantViolation
from .cluster import BorrowRecord, SimCluster

__all__ = [
    "BorrowRecord",
    "FaultPlan",
    "FlakyTier",
    "InvariantChecker",
    "InvariantViolation",
    "SimCluster",
    "SimTimeout",
    "VirtualClock",
]
