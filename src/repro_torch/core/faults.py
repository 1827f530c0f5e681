"""Deterministic fault injection, retry policy, and tier health.

Seeded, Clock-driven fault schedules over the REAL tiers and the async RDMA
engine, usable under any :class:`~repro_torch.core.clock.Clock`.  The seam
is an optional :class:`FaultInjector` attribute on
:class:`repro_torch.core.pool.MemoryTier` — when absent (the default) the
serving paths pay a single ``is None`` check and the modeled cost ledger is
bit-identical to the fault-free path.

Fault classes:

* **read timeouts** — count-windowed over ``[lo, hi)`` tier offsets, raised
  as :class:`TierFaultError` (``kind="timeout"``) before any bytes move;
* **write faults** — symmetric to reads (``kind="write"``);
* **completion errors** — lost RDMA CQEs (``kind="completion"``), raised
  after the copy so a retry re-transfers the extent;
* **per-page CXL poison** — the bytes *returned* by a read are corrupted in
  place (one byte per poisoned page of the returned tensor), the data at
  rest stays clean, so the checksum-repair path's budgeted re-read from the
  home tier observes clean bytes once the schedule drains;
* **brownout windows** — clock intervals during which every *host-link*
  access to a tier fails hard (``kind="brownout"``); owner-side pool-fabric
  access is unaffected.
"""
from __future__ import annotations

import dataclasses
import random
import threading
from typing import Callable, Dict, List, Optional, Tuple, TypeVar

import torch

from .clock import REAL_CLOCK, Clock
from .pagestore import PAGE_SIZE

T = TypeVar("T")


class TierFaultError(RuntimeError):
    """An injected (or detected) transient tier fault.

    ``kind``: ``"timeout"`` | ``"write"`` | ``"completion"`` | ``"brownout"``.
    """

    def __init__(self, msg: str, tier: str = "", kind: str = "timeout"):
        super().__init__(msg)
        self.tier = tier
        self.kind = kind


@dataclasses.dataclass
class _Window:
    """Inject for the next ``remaining`` matching ops touching [lo, hi)."""

    remaining: int
    lo: int = 0
    hi: int = 1 << 62


class FaultInjector:
    """Seeded fault schedules, shared by every component holding the pool.

    Builder methods return ``self`` (the ``FlakyTier`` idiom) so schedules
    chain: ``FaultInjector(seed=7).fail_reads("rdma", 2).brownout("cxl",
    0.0, 1e-3)``.  All schedule state is guarded by one lock; window
    consumption is count-based, so a given access sequence observes an
    identical fault pattern on every run regardless of wall-clock timing.
    """

    def __init__(self, clock: Optional[Clock] = None, seed: int = 0):
        self.clock = clock or REAL_CLOCK
        self.seed = int(seed)
        self.rng = random.Random(self.seed ^ 0x5EED5)
        self._t0 = self.clock.monotonic()
        self._lock = threading.Lock()
        self._reads: Dict[str, List[_Window]] = {}
        self._writes: Dict[str, List[_Window]] = {}
        self._poison: Dict[str, List[_Window]] = {}
        self._completions: Dict[str, int] = {}
        self._brownouts: Dict[str, List[Tuple[float, float]]] = {}
        self.stats = {
            "reads": 0, "writes": 0,
            "injected_timeouts": 0, "injected_write_faults": 0,
            "injected_completion_errors": 0, "injected_poison": 0,
            "brownout_rejections": 0,
        }

    # -- schedule builders -------------------------------------------------
    def fail_reads(self, tier: str, n: int = 1, lo: int = 0,
                   hi: int = 1 << 62) -> "FaultInjector":
        self._reads.setdefault(tier, []).append(_Window(n, lo, hi))
        return self

    def fail_writes(self, tier: str, n: int = 1, lo: int = 0,
                    hi: int = 1 << 62) -> "FaultInjector":
        self._writes.setdefault(tier, []).append(_Window(n, lo, hi))
        return self

    def poison_reads(self, tier: str, n: int = 1, lo: int = 0,
                     hi: int = 1 << 62) -> "FaultInjector":
        self._poison.setdefault(tier, []).append(_Window(n, lo, hi))
        return self

    def fail_completions(self, tier: str, n: int = 1) -> "FaultInjector":
        self._completions[tier] = self._completions.get(tier, 0) + int(n)
        return self

    def brownout(self, tier: str, start_s: float = 0.0,
                 duration_s: float = 1e-3) -> "FaultInjector":
        """Host-link brownout during [t0+start_s, t0+start_s+duration_s)."""
        self._brownouts.setdefault(tier, []).append(
            (self._t0 + start_s, self._t0 + start_s + duration_s))
        return self

    # -- checks (called from the tier/engine seams) ------------------------
    def in_brownout(self, tier: str) -> bool:
        now = self.clock.monotonic()
        return any(a <= now < b for a, b in self._brownouts.get(tier, ()))

    @staticmethod
    def _take(windows: Optional[List[_Window]], offset: int, nbytes: int) -> bool:
        if not windows:
            return False
        for w in windows:
            if w.remaining > 0 and offset < w.hi and offset + nbytes > w.lo:
                w.remaining -= 1
                return True
        return False

    def check_read(self, tier: str, offset: int, nbytes: int,
                   host_link: bool = False) -> None:
        with self._lock:
            self.stats["reads"] += 1
            if host_link and self.in_brownout(tier):
                self.stats["brownout_rejections"] += 1
                raise TierFaultError(
                    f"injected {tier} brownout: read({offset}, {nbytes})",
                    tier=tier, kind="brownout")
            if self._take(self._reads.get(tier), offset, nbytes):
                self.stats["injected_timeouts"] += 1
                raise TierFaultError(
                    f"injected {tier} read timeout: read({offset}, {nbytes})",
                    tier=tier, kind="timeout")

    def check_write(self, tier: str, offset: int, nbytes: int) -> None:
        with self._lock:
            self.stats["writes"] += 1
            if self._take(self._writes.get(tier), offset, nbytes):
                self.stats["injected_write_faults"] += 1
                raise TierFaultError(
                    f"injected {tier} write fault: write({offset}, {nbytes})",
                    tier=tier, kind="write")

    def check_completion(self, tier: str) -> None:
        with self._lock:
            n = self._completions.get(tier, 0)
            if n > 0:
                self._completions[tier] = n - 1
                self.stats["injected_completion_errors"] += 1
                raise TierFaultError(
                    f"injected {tier} completion error", tier=tier,
                    kind="completion")

    def filter_read(self, tier: str, offset: int, nbytes: int,
                    data: torch.Tensor) -> bool:
        """Apply per-page poison to the bytes a read RETURNED, in place."""
        wins = self._poison.get(tier)
        if not wins:
            return False
        hit = False
        with self._lock:
            for k in range(max(1, -(-nbytes // PAGE_SIZE))):
                a = offset + k * PAGE_SIZE
                b = min(offset + nbytes, a + PAGE_SIZE)
                if b <= a:
                    break
                if self._take(wins, a, b - a):
                    data[k * PAGE_SIZE].bitwise_xor_(0xFF)
                    self.stats["injected_poison"] += 1
                    hit = True
        return hit


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded re-issue with seeded exponential backoff + jitter.

    Demand faults escalate: their backoffs are scaled by ``demand_scale``
    and bounded by the tighter ``demand_deadline_s`` (a blocked guest vCPU
    cannot wait out a prefetch-grade deadline), while background extent
    reads get the full ``extent_deadline_s`` budget.  Deadlines bound the
    cumulative *modeled* backoff per operation, so they behave identically
    under ``RealClock`` and ``VirtualClock``.
    """

    max_retries: int = 4
    base_backoff_s: float = 50e-6
    max_backoff_s: float = 5e-3
    jitter_frac: float = 0.25
    demand_scale: float = 0.25
    extent_deadline_s: float = 0.25
    demand_deadline_s: float = 0.05

    def backoff_s(self, attempt: int, rng: Optional[random.Random] = None,
                  urgent: bool = False) -> float:
        b = min(self.max_backoff_s, self.base_backoff_s * (2.0 ** attempt))
        if urgent:
            b *= self.demand_scale
        if rng is not None:
            b *= 1.0 + self.jitter_frac * rng.random()
        return b

    def deadline_s(self, urgent: bool = False) -> float:
        return self.demand_deadline_s if urgent else self.extent_deadline_s


DEFAULT_RETRY_POLICY = RetryPolicy()


def call_with_retries(fn: Callable[[], T], *,
                      policy: RetryPolicy = DEFAULT_RETRY_POLICY,
                      rng: Optional[random.Random] = None,
                      ledger=None,
                      clock: Optional[Clock] = None,
                      urgent: bool = False,
                      trace: Optional[List[float]] = None) -> T:
    """Run ``fn``, retrying :class:`TierFaultError` under ``policy``.

    Every backoff is charged to ``ledger`` (key ``"retry_backoff"``) and
    slept on ``clock`` so modeled time stays honest under both clocks;
    ``trace`` (when given) records the exact backoff sequence — the
    determinism property tests compare it across runs.  Brownout faults are
    never retried: the caller's circuit breaker degrades instead of
    hammering a browned-out link.
    """
    attempt = 0
    spent = 0.0
    while True:
        try:
            return fn()
        except TierFaultError as e:
            if e.kind == "brownout" or attempt >= policy.max_retries:
                raise
            bk = policy.backoff_s(attempt, rng, urgent)
            if spent + bk > policy.deadline_s(urgent):
                raise
            spent += bk
            if trace is not None:
                trace.append(bk)
            if ledger is not None:
                ledger.add("retry_backoff", bk)
            if clock is not None:
                clock.sleep(bk)
            attempt += 1


class TierHealth:
    """Per-tier host-link circuit breaker: CLOSED → OPEN → HALF_OPEN.

    ``record_failure(hard=True)`` (a brownout) trips immediately; soft
    failures trip after ``failure_threshold``.  An OPEN breaker admits no
    traffic until ``cooldown_s`` of clock time elapses, then transitions to
    HALF_OPEN and admits probe traffic: one success closes it, one failure
    re-opens it.  Serving consults :meth:`allow` before touching the link
    and falls back to the degraded RDMA-only path while the breaker is
    open; :meth:`degraded` feeds the fleet placement score.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, name: str, clock: Optional[Clock] = None,
                 failure_threshold: int = 3, cooldown_s: float = 2e-3):
        self.name = name
        self.clock = clock or REAL_CLOCK
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()
        self.stats = {"failures": 0, "trips": 0, "probes": 0, "recoveries": 0}

    def allow(self) -> bool:
        """Should a caller attempt the real link right now?"""
        if self.state == self.CLOSED:
            return True
        with self._lock:
            if (self.state == self.OPEN
                    and self.clock.monotonic() - self._opened_at
                    >= self.cooldown_s):
                self.state = self.HALF_OPEN
                self.stats["probes"] += 1
            return self.state != self.OPEN

    def record_failure(self, hard: bool = False) -> None:
        with self._lock:
            self.stats["failures"] += 1
            self._failures += 1
            if (hard or self._failures >= self.failure_threshold
                    or self.state == self.HALF_OPEN):
                if self.state != self.OPEN:
                    self.stats["trips"] += 1
                self.state = self.OPEN
                self._opened_at = self.clock.monotonic()

    def record_success(self) -> None:
        # fast path: a healthy link takes no lock on the hot serving path
        if self.state == self.CLOSED and self._failures == 0:
            return
        with self._lock:
            if self.state == self.HALF_OPEN:
                self.stats["recoveries"] += 1
            self.state = self.CLOSED
            self._failures = 0

    @property
    def degraded(self) -> bool:
        return self.state != self.CLOSED
