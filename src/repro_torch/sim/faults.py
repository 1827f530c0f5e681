"""Fault injection for the cluster simulator.

Two deterministic mechanisms, both scripted per scenario:

* **label kills** — kill a host program the k-th time it yields a given
  step label.  Because program labels mark protocol phase boundaries
  (``publish:tombstoned``, ``borrow:refcount_incremented``, ...), this
  expresses crashes like "owner dies between tombstone and republish" or
  "host dies mid-borrow" exactly.
* **step hooks** — run an arbitrary callback just before global step N
  (advance the virtual clock past a lease timeout, crash a node, ...).

``FlakyTier`` wraps a ``MemoryTier`` and fails reads/writes with
:class:`SimTimeout` per script — the RDMA extent timeout/retry fault.  It is
the reference implementation of count-windowed fault schedules: the
production seam (:class:`repro_torch.core.faults.FaultInjector`) is
parity-tested against it, and :class:`SimTimeout` subclasses
:class:`repro_torch.core.faults.TierFaultError` so one ``except`` clause
covers both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from ..core.faults import TierFaultError
from ..core.pool import MemoryTier


class SimTimeout(TierFaultError):
    """Injected transfer timeout (RDMA extent read deadline exceeded)."""


class FaultPlan:
    """Scripted faults for one scenario run.  All triggers are functions of
    (program label occurrence, global step number) — both deterministic under
    a fixed seed — so an injected fault replays exactly."""

    def __init__(self):
        # program -> list of [label, remaining_occurrences]
        self._kills: Dict[str, List[List]] = {}
        self._step_hooks: Dict[int, List[Callable]] = {}

    def kill_after(self, program: str, label: str, occurrence: int = 1) -> "FaultPlan":
        """Kill ``program`` right after it yields ``label`` for the
        ``occurrence``-th time (the program never runs again; any refcounts
        or borrows it holds leak, exactly like a host crash)."""
        self._kills.setdefault(program, []).append([label, occurrence])
        return self

    def at_step(self, step_no: int, hook: Callable) -> "FaultPlan":
        """Run ``hook(cluster)`` immediately before global step ``step_no``."""
        self._step_hooks.setdefault(step_no, []).append(hook)
        return self

    # -- used by the scheduler -------------------------------------------------
    def should_kill(self, program: str, label: str) -> bool:
        for entry in self._kills.get(program, ()):
            if entry[0] == label:
                entry[1] -= 1
                if entry[1] <= 0:
                    return True
        return False

    def run_step_hooks(self, step_no: int, cluster) -> None:
        for hook in self._step_hooks.pop(step_no, ()):
            hook(cluster)


@dataclasses.dataclass
class _FailWindow:
    remaining: int                      # how many more reads to fail
    lo: int = 0                         # offset range the fault applies to
    hi: int = 1 << 62


class FlakyTier:
    """Read/write-path proxy over a :class:`MemoryTier` injecting timeouts.

    Everything except ``read``/``write`` is delegated to the wrapped tier,
    so the proxy can be handed to ``SnapshotReader`` in place of the RDMA
    tier.  Scripted failures are consumed in call order → deterministic.
    Stats are symmetric across both directions: ``reads`` /
    ``injected_timeouts`` mirror ``writes`` / ``injected_write_faults``.

    The wrapped tier's arena (``buf``, ``page_rows()``) stays reachable
    through the delegation, and a read by address there would skip the
    script; ``injects_faults`` tells a restore walk that reads of this tier
    can fail, so it runs extent by extent through :meth:`read` (the walk
    counts ``walk_routes["per_extent"]["injector"]``).
    """

    injects_faults = True

    def __init__(self, tier: MemoryTier):
        self._tier = tier
        self._windows: List[_FailWindow] = []
        self._write_windows: List[_FailWindow] = []
        self.stats = {"reads": 0, "injected_timeouts": 0,
                      "writes": 0, "injected_write_faults": 0}

    def fail_reads(self, n: int, lo: int = 0, hi: int = 1 << 62) -> "FlakyTier":
        """Fail the next ``n`` reads that touch [lo, hi)."""
        self._windows.append(_FailWindow(n, lo, hi))
        return self

    def fail_writes(self, n: int, lo: int = 0, hi: int = 1 << 62) -> "FlakyTier":
        """Fail the next ``n`` writes that touch [lo, hi)."""
        self._write_windows.append(_FailWindow(n, lo, hi))
        return self

    @staticmethod
    def _take(windows: List[_FailWindow], offset: int, nbytes: int) -> bool:
        for w in windows:
            if w.remaining > 0 and offset < w.hi and offset + nbytes > w.lo:
                w.remaining -= 1
                return True
        return False

    def read(self, offset: int, nbytes: int) -> torch.Tensor:
        self.stats["reads"] += 1
        if self._take(self._windows, offset, nbytes):
            self.stats["injected_timeouts"] += 1
            raise SimTimeout(
                f"injected RDMA timeout: read({offset}, {nbytes})",
                tier=self._tier.name, kind="timeout")
        return self._tier.read(offset, nbytes)

    def write(self, offset: int, data: torch.Tensor) -> None:
        self.stats["writes"] += 1
        nbytes = int(data.numel() * data.element_size())
        if self._take(self._write_windows, offset, nbytes):
            self.stats["injected_write_faults"] += 1
            raise SimTimeout(
                f"injected RDMA write fault: write({offset}, {nbytes})",
                tier=self._tier.name, kind="write")
        return self._tier.write(offset, data)

    def __getattr__(self, name):
        return getattr(self._tier, name)
