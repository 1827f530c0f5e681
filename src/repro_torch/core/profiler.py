"""Online hotness feedback: typed touch telemetry and decayed heat maps.

Every restore exports per-``(name, version)`` access telemetry — demand
faults, prefetch hits and guest touches — into a :class:`HeatMap`, a decayed
per-page counter array.  Telemetry enters as typed :class:`TouchEvent`
records through ``HeatRegistry.record``; events that carry a ``stream`` id
additionally feed a *first-touch sequence* model: the map counts page-run →
page-run transitions over each stream's first touches (``RUN_PAGES`` pages
per run, virtual ``START_RUN`` before the first), which
``core/prefetch_model.fit_prefetch_model`` turns into a Markov
predicted-next-touch ordering.

This is host-side control state (numpy), as a real uffd handler keeps it;
no page bytes pass through here.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from .clock import Clock, REAL_CLOCK


# --------------------------------------------------------------------------
# Online hotness feedback
# --------------------------------------------------------------------------

#: pages per sequence "run" — the granule of the first-touch Markov model.
RUN_PAGES = 8
#: virtual run a stream is in before its first touch (restore entry point).
START_RUN = -1


@dataclasses.dataclass(frozen=True)
class TouchEvent:
    """One typed telemetry observation: pages *in touch order* plus its kind.

    This is the single shape every telemetry producer emits
    (``HeatRegistry.record`` / ``HeatMap.record`` consume it):

      pages        page indices, ordered as the guest touched them;
      kind         ``demand_fault`` / ``prefetch_hit`` / ``touch``
                   (``HeatMap.KIND_WEIGHT`` sets the heat weight);
      stream       opaque per-restore sequence id — when set, the event also
                   feeds the first-touch run-transition counts behind
                   ``core/prefetch_model``; ``None`` means heat-only
                   (order-free) telemetry;
      name/version/total_pages
                   address the target map when fed through
                   ``HeatRegistry.record``; unused by ``HeatMap.record``;
      weight/now   optional overrides (tests, replayed traces).
    """

    pages: object
    kind: str = "demand_fault"
    name: Optional[str] = None
    version: Optional[int] = None
    total_pages: Optional[int] = None
    stream: Optional[int] = None
    weight: Optional[float] = None
    now: Optional[float] = None


class HeatMap:
    """Decayed per-page access-heat accumulator for one ``(name, version)``.

    Counters decay exponentially with half-life ``half_life_s`` in the
    pod clock's time base (lazy, vectorized: one multiply of the whole
    array per observation batch, no per-page timers).  Three telemetry
    kinds feed it, each with its own weight:

      demand_fault  1.0   cold page demand-faulted over RDMA — the page the
                          frozen hot set is most wrong about;
      prefetch_hit  0.6   demand fault that landed while a prefetch extent
                          covering the page was already in flight (latency
                          partially hidden, but the page is clearly needed);
      touch         0.25  guest touch served without a major fault (hot
                          pre-installed or already prefetched) — the
                          keep-me-hot signal for demotion scoring.

    Beyond decayed heat, events that carry a ``stream`` id feed *first-touch
    sequences*: pages collapse to runs of ``run_pages``, and for each stream
    only the first touch of a run counts — recording a ``prev_run → run``
    transition (``START_RUN`` before the first).  These counts are the
    sufficient statistic for the Markov predicted-next-touch model in
    ``core/prefetch_model``.

    Thread-safe: fault handlers and completion workers record concurrently.
    """

    KIND_WEIGHT = {"demand_fault": 1.0, "prefetch_hit": 0.6, "touch": 0.25}

    def __init__(self, total_pages: int, half_life_s: float = 30.0,
                 clock: Optional[Clock] = None, run_pages: int = RUN_PAGES):
        self.total_pages = total_pages
        self.half_life_s = float(half_life_s)
        self.clock = clock or REAL_CLOCK
        self.run_pages = int(run_pages)
        self.n_runs = -(-int(total_pages) // self.run_pages)
        self._counts = np.zeros(total_pages, dtype=np.float64)
        self._last_t = self.clock.monotonic()
        self._lock = threading.Lock()
        self.restores = 0
        self._transitions: Dict[Tuple[int, int], float] = {}
        self._stream_prev: Dict[int, int] = {}
        self._stream_seen: Dict[int, set] = {}
        self.stats = {"demand_faults": 0, "prefetch_hits": 0, "touches": 0,
                      "records": 0, "seq_transitions": 0}

    def _decay_locked(self, now: float) -> None:
        dt = now - self._last_t
        if dt <= 0.0:
            return
        self._counts *= 0.5 ** (dt / self.half_life_s)
        self._last_t = now

    def record(self, event: TouchEvent) -> None:
        """Accumulate one :class:`TouchEvent` (vectorized; duplicates add up)."""
        pages = np.asarray(event.pages, dtype=np.int64).reshape(-1)
        if pages.size == 0:
            return
        w = (self.KIND_WEIGHT[event.kind] if event.weight is None
             else float(event.weight))
        t = self.clock.monotonic() if event.now is None else float(event.now)
        with self._lock:
            self._decay_locked(t)
            np.add.at(self._counts, pages, w)
            self.stats["records"] += 1
            if event.kind == "demand_fault":
                self.stats["demand_faults"] += int(pages.size)
            elif event.kind == "prefetch_hit":
                self.stats["prefetch_hits"] += int(pages.size)
            else:
                self.stats["touches"] += int(pages.size)
            if event.stream is not None:
                self._record_sequence_locked(int(event.stream), pages)

    # -- first-touch sequence telemetry ------------------------------------
    def _record_sequence_locked(self, stream: int, pages: np.ndarray) -> None:
        runs = pages // self.run_pages
        if runs.size > 1:
            keep = np.empty(runs.size, dtype=bool)
            keep[0] = True
            keep[1:] = runs[1:] != runs[:-1]          # collapse intra-run steps
            runs = runs[keep]
        seen = self._stream_seen.setdefault(stream, set())
        prev = self._stream_prev.get(stream, START_RUN)
        added = 0
        for r in runs.tolist():
            if r in seen:
                continue                              # first touch only
            seen.add(r)
            key = (prev, r)
            self._transitions[key] = self._transitions.get(key, 0.0) + 1.0
            prev = r
            added += 1
        self._stream_prev[stream] = prev
        self.stats["seq_transitions"] += added

    def end_stream(self, stream: int) -> None:
        """Forget a stream's cursor (restore detached); its recorded
        transitions stay — only the per-stream dedup state is dropped."""
        with self._lock:
            self._stream_prev.pop(int(stream), None)
            self._stream_seen.pop(int(stream), None)

    def transition_counts(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(src_runs, dst_runs, counts)`` of recorded first-touch
        transitions, sorted by ``(src, dst)`` for deterministic model fits.
        ``src`` may be ``START_RUN``; counts are raw (undecayed) tallies."""
        with self._lock:
            if not self._transitions:
                z = np.zeros(0, dtype=np.int64)
                return z, z.copy(), np.zeros(0, dtype=np.float64)
            keys = sorted(self._transitions)
            src = np.asarray([k[0] for k in keys], dtype=np.int64)
            dst = np.asarray([k[1] for k in keys], dtype=np.int64)
            cnt = np.asarray([self._transitions[k] for k in keys],
                             dtype=np.float64)
            return src, dst, cnt

    def note_restore(self) -> None:
        """Called once per restore of this snapshot (demotion scoring needs
        to know how many chances a hot page had to be touched)."""
        with self._lock:
            self.restores += 1

    def counts(self, now: Optional[float] = None) -> np.ndarray:
        """Decayed heat per page at ``now`` (copy; does not mutate state
        when an explicit ``now`` is given)."""
        with self._lock:
            if now is None:
                self._decay_locked(self.clock.monotonic())
                return self._counts.copy()
            dt = max(0.0, float(now) - self._last_t)
            return self._counts * (0.5 ** (dt / self.half_life_s))

    def promotion_candidates(self, cold_pages: np.ndarray,
                             min_heat: float = 1.0) -> np.ndarray:
        """Cold pages whose decayed heat says they belong in CXL."""
        cold_pages = np.asarray(cold_pages, dtype=np.int64)
        if cold_pages.size == 0:
            return cold_pages
        c = self.counts()
        return cold_pages[c[cold_pages] >= min_heat]

    def demotion_candidates(self, hot_pages: np.ndarray,
                            max_heat: float = 1e-3,
                            min_restores: int = 2) -> np.ndarray:
        """Hot pages never (meaningfully) touched across enough restores."""
        hot_pages = np.asarray(hot_pages, dtype=np.int64)
        if hot_pages.size == 0 or self.restores < min_restores:
            return np.zeros(0, dtype=np.int64)
        c = self.counts()
        return hot_pages[c[hot_pages] <= max_heat]


class HeatRegistry:
    """Pod-level registry of heat maps, keyed ``(name, version)``.

    Restore sessions resolve their map here at attach time, so telemetry
    from every host lands in one place the re-curation pipeline can read.
    """

    def __init__(self, clock: Optional[Clock] = None, half_life_s: float = 30.0):
        self.clock = clock or REAL_CLOCK
        self.half_life_s = half_life_s
        self._lock = threading.Lock()
        self.maps: Dict[Tuple[str, int], HeatMap] = {}

    def map_for(self, name: str, version: int, total_pages: int) -> HeatMap:
        key = (name, int(version))
        with self._lock:
            hm = self.maps.get(key)
            if hm is None:
                hm = self.maps[key] = HeatMap(total_pages, self.half_life_s,
                                              clock=self.clock)
            return hm

    def record(self, event: TouchEvent) -> HeatMap:
        """THE typed telemetry entrypoint: resolve the event's
        ``(name, version)`` map and feed it (sequence order included when
        the event carries a ``stream``).  Returns the map so callers can
        cache it for the session's lifetime."""
        if event.name is None or event.version is None \
                or event.total_pages is None:
            raise ValueError(
                "HeatRegistry.record needs name, version and total_pages "
                "set on the TouchEvent")
        hm = self.map_for(event.name, event.version, int(event.total_pages))
        hm.record(event)
        return hm

    def find(self, name: str, version: int) -> Optional[HeatMap]:
        with self._lock:
            return self.maps.get((name, int(version)))

    def latest(self, name: str) -> Optional[Tuple[int, HeatMap]]:
        """(version, map) with the highest version recorded for ``name``."""
        with self._lock:
            versions = [v for (n, v) in self.maps if n == name]
            if not versions:
                return None
            v = max(versions)
            return v, self.maps[(name, v)]

    def prune(self, name: str, min_version: int) -> int:
        """Drop ``name``'s maps below ``min_version`` (superseded snapshot
        versions — the master prunes to version-1 on every publish, so a
        long-lived pod keeps at most the current and the draining version
        per name instead of one counter array per republish forever)."""
        with self._lock:
            dead = [k for k in self.maps if k[0] == name and k[1] < min_version]
            for k in dead:
                del self.maps[k]
            return len(dead)
