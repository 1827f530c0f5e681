"""Injectable time source for the whole coherence/failover/serving stack.

Every place the stack used to call ``time.time()`` / ``time.monotonic()`` /
``time.sleep()`` now goes through a :class:`Clock` handle, defaulting to
:data:`REAL_CLOCK` (the wall clock).  A deterministic cluster simulator
injects a virtual clock instead, so timeouts, lease
expiries and drain waits become discrete-event state that reproduces exactly
from a seed — no wall-clock races in tests.

The interface deliberately covers the three blocking primitives the stack
uses, not just "now":

* :meth:`Clock.sleep` — plain delay (poll loops, backoff);
* :meth:`Clock.wait_event` — ``threading.Event.wait`` with a timeout
  (heartbeat loops that must exit promptly on ``stop``);
* :meth:`Clock.cv_wait_for` — ``Condition.wait_for`` with a timeout
  (page-install waits).

Under the real clock these delegate to the stdlib primitives; a virtual
clock can instead advance simulated time and re-check the predicate.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class Clock:
    """Time-source interface; see module docstring.  Subclass and override."""

    def time(self) -> float:
        raise NotImplementedError

    def monotonic(self) -> float:
        raise NotImplementedError

    def monotonic_ns(self) -> int:
        return int(self.monotonic() * 1e9)

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def wait_event(self, event: threading.Event, timeout_s: float) -> bool:
        """Block up to ``timeout_s`` for ``event``; True iff it is set."""
        raise NotImplementedError

    def cv_wait_for(self, cv: threading.Condition, predicate: Callable[[], bool],
                    timeout_s: Optional[float]) -> bool:
        """``Condition.wait_for`` analogue; caller must hold ``cv``.
        ``timeout_s=None`` waits indefinitely (until a notify satisfies the
        predicate) — condition-driven loops use it so an idle thread parks
        with ZERO periodic wakeups instead of spin-polling a timeout."""
        raise NotImplementedError


class RealClock(Clock):
    """The wall clock — production default."""

    def time(self) -> float:
        return time.time()

    def monotonic(self) -> float:
        return time.monotonic()

    def monotonic_ns(self) -> int:
        return time.monotonic_ns()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def wait_event(self, event: threading.Event, timeout_s: float) -> bool:
        return event.wait(timeout_s)

    def cv_wait_for(self, cv: threading.Condition, predicate: Callable[[], bool],
                    timeout_s: Optional[float]) -> bool:
        return cv.wait_for(predicate, timeout=timeout_s)


REAL_CLOCK = RealClock()
