"""Learned first-touch ordering + the PrefetchPolicy seam.

* :func:`fit_prefetch_model` turns a :class:`~repro_torch.core.profiler.HeatMap`'s
  first-touch run-transition counts into a :class:`PrefetchModel` — a
  row-stochastic Markov matrix over page runs plus a START distribution.
  Ordering scores are *discounted multi-step reachability* from a seed run
  (``Σ_{k=1..K} γ^k · v0 Pᵏ``).  Fitting and scoring are deterministic: no
  RNG, stable ``(score desc, position asc)`` tie-breaks.

* :class:`PrefetchPolicy` is the single public ordering seam on
  ``RestoreEngine``: ``order_extents(session, faulting_page) -> iterator`` of
  the session reader's cold-extent tuples ``(es, en, rank0, pool_off,
  nbytes)``.  :class:`LayoutOrderPolicy` walks the layout (largest cold runs
  first, the default); :class:`PredictedOrderPolicy` re-orders the same
  extents by predicted next-touch and re-seeds from the faulting page at each
  demand miss.  Policies only *re-order* the extent walk — they never change
  the split arithmetic, so installed bytes stay bit-identical either way.

The reachability matvecs run in **float32** on the CPU: the reference
evaluates them in float32 (its array library's default precision), and the
lexsort tie-breaks — with them the extent order — follow the scores, so the
port keeps that precision.  This is host-side control state.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .profiler import START_RUN, HeatMap

#: (es, en, rank0, pool_off, nbytes) — the shape ``iter_cold_extents`` yields.
Extent = Tuple[int, int, int, int, int]


def _discounted_reachability(trans: np.ndarray, v0: np.ndarray,
                             discount: float, horizon: int) -> np.ndarray:
    """``Σ_{k=1..horizon} discount^k · (v0 · transᵏ)`` — probability-mass of
    touching each run within the next ``horizon`` first-touch steps, geared
    toward sooner touches.  One (1×n)·(n×n) float32 matvec per step."""
    t = torch.from_numpy(np.asarray(trans)).to(torch.float32)
    v = torch.from_numpy(np.asarray(v0)).to(torch.float32)
    acc = torch.zeros_like(v)
    g = 1.0
    for _ in range(horizon):
        v = v @ t
        g *= discount
        acc = acc + g * v
    return acc.numpy().astype(np.float64)


@dataclasses.dataclass
class PrefetchModel:
    """Markov first-touch model over page runs for one ``(name, version)``.

    ``trans[i, j]`` is the probability that run ``j`` is first-touched right
    after run ``i``; ``start`` is the distribution of the very first run a
    restore touches.  Scores are cached per seed run (the model is frozen
    once fitted — refit through the policy when telemetry grows)."""

    run_pages: int
    n_runs: int
    trans: np.ndarray                   # (n_runs, n_runs) row-stochastic
    start: np.ndarray                   # (n_runs,) START_RUN → run
    discount: float = 0.6
    horizon: int = 16

    def __post_init__(self):
        self._score_cache: dict = {}
        self._lock = threading.Lock()

    def run_scores(self, seed_run: Optional[int] = None) -> np.ndarray:
        """Predicted-next-touch score per run, seeded at ``seed_run`` (the
        faulting page's run) or at the START distribution when ``None`` /
        untrained."""
        key = (int(seed_run) if seed_run is not None
               and 0 <= int(seed_run) < self.n_runs
               and bool(self.trans[int(seed_run)].any()) else None)
        with self._lock:
            cached = self._score_cache.get(key)
        if cached is not None:
            return cached
        if key is None:
            v0 = self.start.astype(np.float64, copy=True)
        else:
            v0 = np.zeros(self.n_runs, dtype=np.float64)
            v0[key] = 1.0
        scores = _discounted_reachability(self.trans, v0,
                                          self.discount, self.horizon)
        if key is None:
            # START seed: v0 itself is the predicted FIRST touch — include
            # it at full weight.  (Seeded at a faulting page the seed run is
            # already being demand-fetched, so only successors score.)
            scores = scores + v0
        with self._lock:
            self._score_cache[key] = scores
        return scores

    def run_order(self, seed_run: Optional[int] = None) -> np.ndarray:
        """All runs ranked by predicted next-touch (score desc, run asc)."""
        s = self.run_scores(seed_run)
        return np.lexsort((np.arange(self.n_runs), -s))

    def page_order(self, pages) -> np.ndarray:
        """``pages`` re-ranked by their run's predicted-first-touch score
        (stable: page index breaks ties) — re-curation uses this so the hot
        set tracks observed touch order."""
        pages = np.asarray(pages, dtype=np.int64)
        if pages.size == 0:
            return pages
        s = self.run_scores(None)
        order = np.lexsort((pages, -s[pages // self.run_pages]))
        return pages[order]


def fit_prefetch_model(heat: Optional[HeatMap], discount: float = 0.6,
                       horizon: int = 16) -> Optional[PrefetchModel]:
    """Fit a :class:`PrefetchModel` from a map's first-touch transition
    counts.  ``None`` when there is no sequence telemetry yet (cold start —
    callers fall back to layout order)."""
    if heat is None:
        return None
    src, dst, cnt = heat.transition_counts()
    if cnt.size == 0:
        return None
    n = int(heat.n_runs)
    trans = np.zeros((n, n), dtype=np.float64)
    start = np.zeros(n, dtype=np.float64)
    from_start = src == START_RUN
    np.add.at(start, dst[from_start], cnt[from_start])
    inner = ~from_start
    np.add.at(trans, (src[inner], dst[inner]), cnt[inner])
    row_sums = trans.sum(axis=1, keepdims=True)
    np.divide(trans, row_sums, out=trans, where=row_sums > 0)
    total = start.sum()
    if total > 0:
        start /= total
    return PrefetchModel(int(heat.run_pages), n, trans, start,
                         float(discount), int(horizon))


# --------------------------------------------------------------------------
# The policy seam
# --------------------------------------------------------------------------

class PrefetchPolicy:
    """Protocol: the single public cold-extent ordering seam.

    ``order_extents(session, faulting_page)`` yields the session reader's
    cold extents ``(es, en, rank0, pool_off, nbytes)`` in fetch order.
    ``session`` is any object with ``.reader`` (and optionally ``.heat``);
    ``faulting_page`` re-seeds prediction at a demand miss (``None`` for the
    initial walk).  ``reseed_on_demand`` tells the pump whether a demand
    miss should re-order the already-queued extents."""

    max_extent_pages: int = 64
    reseed_on_demand: bool = False

    def order_extents(self, session,
                      faulting_page: Optional[int] = None) -> Iterator[Extent]:
        raise NotImplementedError


class LayoutOrderPolicy(PrefetchPolicy):
    """Snapshot-layout order (largest cold runs first) — the default."""

    def __init__(self, max_extent_pages: int = 64):
        self.max_extent_pages = int(max_extent_pages)

    def order_extents(self, session,
                      faulting_page: Optional[int] = None) -> Iterator[Extent]:
        return iter(list(
            session.reader.iter_cold_extents(self.max_extent_pages)))

    def __repr__(self):
        return f"LayoutOrderPolicy(max_extent_pages={self.max_extent_pages})"


class PredictedOrderPolicy(PrefetchPolicy):
    """Predicted-next-touch order from the session's HeatMap.

    Lazily fits (and re-fits when telemetry grows) a :class:`PrefetchModel`
    from ``session.heat``; with no telemetry it degrades to exactly
    :class:`LayoutOrderPolicy`'s order.  Extents are scored by the best run
    they cover and re-seeded from the faulting page's run on demand misses.
    """

    reseed_on_demand = True

    def __init__(self, max_extent_pages: int = 64,
                 model: Optional[PrefetchModel] = None,
                 discount: float = 0.6, horizon: int = 16):
        self.max_extent_pages = int(max_extent_pages)
        self.model = model
        self.discount = float(discount)
        self.horizon = int(horizon)
        self._lock = threading.Lock()
        self._fit_key = None
        self._fit_model: Optional[PrefetchModel] = None

    def _resolve_model(self, session) -> Optional[PrefetchModel]:
        if self.model is not None:
            return self.model
        heat = getattr(session, "heat", None)
        if heat is None:
            return None
        # refit only when the sequence telemetry actually grew
        key = (id(heat), heat.stats.get("seq_transitions", 0))
        with self._lock:
            if self._fit_key == key:
                return self._fit_model
        model = fit_prefetch_model(heat, self.discount, self.horizon)
        with self._lock:
            self._fit_key, self._fit_model = key, model
        return model

    def order_extents(self, session,
                      faulting_page: Optional[int] = None) -> Iterator[Extent]:
        base: List[Extent] = list(
            session.reader.iter_cold_extents(self.max_extent_pages))
        model = self._resolve_model(session)
        if model is None or not base:
            return iter(base)           # cold start ⇒ layout order
        seed_run = (int(faulting_page) // model.run_pages
                    if faulting_page is not None else None)
        scores = model.run_scores(seed_run)
        rp = model.run_pages
        ext_scores = np.empty(len(base), dtype=np.float64)
        for i, (es, en, _rank0, _off, _nb) in enumerate(base):
            ext_scores[i] = scores[es // rp:(es + en - 1) // rp + 1].max()
        order = np.lexsort((np.arange(len(base)), -ext_scores))
        return iter([base[i] for i in order])

    def __repr__(self):
        return (f"PredictedOrderPolicy(max_extent_pages="
                f"{self.max_extent_pages}, discount={self.discount})")


def resolve_policy(policy: Optional[PrefetchPolicy]) -> PrefetchPolicy:
    """``policy``, or the default :class:`LayoutOrderPolicy` when it is None."""
    return policy if policy is not None else LayoutOrderPolicy()
