"""Virtual time for the deterministic cluster simulator.

``VirtualClock`` implements the :class:`repro_torch.core.clock.Clock` interface
with a simulated-seconds counter that only moves when the simulation says so
(``sleep``/``advance``).  The blocking primitives never actually block: the
simulator is single-threaded, so if a predicate/event is not already
satisfied, no other runner can satisfy it *during* the wait — the clock
advances by the timeout and the condition is re-checked once.  This turns
every wall-clock race in the stack (lease expiry, drain timeout, page-wait)
into deterministic discrete-event state.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from ..core.clock import Clock


class VirtualClock(Clock):
    """Discrete-event time source; seconds advance only via sleep/advance."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    # -- reading --------------------------------------------------------------
    def time(self) -> float:
        with self._lock:
            return self._now

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def monotonic_ns(self) -> int:
        with self._lock:
            return int(self._now * 1e9)

    # -- advancing ------------------------------------------------------------
    def advance(self, seconds: float) -> None:
        assert seconds >= 0.0, "virtual time cannot run backwards"
        with self._lock:
            self._now += seconds

    def advance_to(self, t: float) -> None:
        """Jump exactly to simulated time ``t`` (no-op if already past it).
        Exact assignment, not ``advance(t - now)``: adding the delta can land
        a float ulp short of ``t`` and leave a sleeper un-runnable."""
        with self._lock:
            self._now = max(self._now, float(t))

    def sleep(self, seconds: float) -> None:
        self.advance(max(0.0, seconds))

    # -- pseudo-blocking primitives -------------------------------------------
    def wait_event(self, event: threading.Event, timeout_s: float) -> bool:
        if event.is_set():
            return True
        self.advance(max(0.0, timeout_s))
        return event.is_set()

    def cv_wait_for(self, cv: threading.Condition, predicate: Callable[[], bool],
                    timeout_s: Optional[float]) -> bool:
        if predicate():
            return True
        if timeout_s is None:
            # an indefinite wait cannot be satisfied in the single-threaded
            # sim (no other runner can notify during it): re-check once
            # without advancing — condition-driven background loops must use
            # background=False / explicit driving under a VirtualClock
            return predicate()
        self.advance(max(0.0, timeout_s))
        return predicate()
