"""Seeded request-arrival generators for the fleet-serving layer.

Serverless traces (the Azure Functions characterization, PAPERS.md) are
heavy-tailed and bursty: a few function types dominate traffic, most are
invoked rarely, and per-function arrivals mix steady Poisson, diurnal
cycles, and ON/OFF bursts.  This module synthesizes such a fleet
deterministically from a seed:

* :func:`poisson_arrivals` — homogeneous Poisson over a window;
* :func:`diurnal_arrivals` — inhomogeneous Poisson with a sinusoidal rate
  (thinning over the peak rate), the day/night cycle shrunk to simulated
  seconds;
* :func:`onoff_arrivals` — a two-state Markov-modulated process: bursts at
  a high ON rate separated by exponential OFF silences;
* :func:`synthesize_fleet` — N function types with Zipf-weighted rates,
  patterns assigned round-robin, each mapped to a snapshot variant of one
  of ``n_bases`` base images (the dedup-overlap structure placement
  exploits);
* :func:`generate_trace` — the merged, time-sorted invocation trace with a
  per-invocation compute time, as flat numpy arrays.

Everything is vectorized numpy on simulated seconds (the fleet driver runs
it on a :class:`~repro_torch.sim.clock.VirtualClock` timeline); per-function
streams draw from ``SeedSequence(seed, fn_id)`` so a trace is bit-identical
for a seed regardless of generation order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

PATTERNS = ("poisson", "diurnal", "onoff")


@dataclasses.dataclass(frozen=True)
class FunctionType:
    """One serverless function type: its snapshot and its traffic shape."""

    fn_id: int
    name: str                   # snapshot name this function restores
    base_group: int             # which base image its snapshot derives from
    rate_rps: float             # long-run mean arrival rate
    pattern: str                # one of PATTERNS
    compute_mean_s: float       # mean modeled execution time per invocation


@dataclasses.dataclass
class Trace:
    """Merged invocation trace (time-sorted, deterministic per seed)."""

    t: np.ndarray               # float64 arrival seconds, non-decreasing
    fn: np.ndarray              # int32 FunctionType.fn_id per invocation
    compute_s: np.ndarray       # float64 modeled execution time per invocation

    def __len__(self) -> int:
        return int(self.t.size)


def poisson_arrivals(rng: np.random.Generator, rate_rps: float,
                     t_end: float, t_start: float = 0.0) -> np.ndarray:
    """Homogeneous Poisson: N ~ Poisson(rate * window), times uniform."""
    window = max(0.0, t_end - t_start)
    n = int(rng.poisson(rate_rps * window))
    if n == 0:
        return np.zeros(0, np.float64)
    return np.sort(rng.uniform(t_start, t_end, n))


def diurnal_arrivals(rng: np.random.Generator, rate_rps: float, t_end: float,
                     period_s: float = 60.0, depth: float = 0.8,
                     t_start: float = 0.0) -> np.ndarray:
    """Inhomogeneous Poisson with rate(t) = rate * (1 + depth sin(2πt/T)),
    sampled by thinning against the peak rate — the day/night cycle of the
    Azure traces shrunk to ``period_s`` simulated seconds."""
    depth = float(np.clip(depth, 0.0, 1.0))
    peak = rate_rps * (1.0 + depth)
    ts = poisson_arrivals(rng, peak, t_end, t_start)
    if ts.size == 0:
        return ts
    lam = rate_rps * (1.0 + depth * np.sin(2.0 * np.pi * ts / period_s))
    keep = rng.uniform(0.0, peak, ts.size) < lam
    return ts[keep]


def onoff_arrivals(rng: np.random.Generator, rate_rps: float, t_end: float,
                   mean_on_s: float = 2.0, mean_off_s: float = 8.0,
                   t_start: float = 0.0) -> np.ndarray:
    """Markov-modulated ON/OFF bursts: exponential ON windows at an elevated
    rate separated by exponential OFF silences.  The ON rate is scaled so
    the long-run mean stays ``rate_rps`` — burstiness changes the shape of
    the arrival process, not the offered load."""
    duty = mean_on_s / (mean_on_s + mean_off_s)
    on_rate = rate_rps / max(duty, 1e-9)
    window = max(0.0, t_end - t_start)
    # enough alternating periods to cover the window with margin
    n_pairs = max(4, int(window / (mean_on_s + mean_off_s) * 3) + 4)
    on_len = rng.exponential(mean_on_s, n_pairs)
    off_len = rng.exponential(mean_off_s, n_pairs)
    # phase: start OFF or ON with duty-cycle probability
    start_on = bool(rng.uniform() < duty)
    durations = np.empty(2 * n_pairs)
    durations[0::2], durations[1::2] = (on_len, off_len) if start_on else (off_len, on_len)
    edges = t_start + np.concatenate(([0.0], np.cumsum(durations)))
    out: List[np.ndarray] = []
    on_slots = range(0, 2 * n_pairs, 2) if start_on else range(1, 2 * n_pairs, 2)
    for i in on_slots:
        a, b = edges[i], min(edges[i + 1], t_end)
        if a >= t_end:
            break
        if b > a:
            out.append(poisson_arrivals(rng, on_rate, b, a))
    if not out:
        return np.zeros(0, np.float64)
    return np.sort(np.concatenate(out))


def zipf_rates(n_types: int, total_rps: float, alpha: float = 1.1) -> np.ndarray:
    """Heavy-tailed per-function rates: rate_i ∝ 1/(i+1)^alpha, normalized
    to ``total_rps`` offered load (the Azure-style skew: a handful of hot
    functions carry most traffic)."""
    w = 1.0 / np.power(np.arange(1, n_types + 1, dtype=np.float64), alpha)
    return total_rps * w / w.sum()


def synthesize_fleet(n_types: int, n_bases: int, total_rps: float,
                     seed: int = 0, alpha: float = 1.1,
                     compute_mean_s: float = 0.25) -> List[FunctionType]:
    """N function types with Zipf rates; type i restores snapshot ``fn{i}``
    derived from base group ``i % n_bases``; patterns round-robin so every
    shape appears at every rate tier.  Compute time scales mildly with rank
    (hot functions tend to be short in the traces)."""
    rates = zipf_rates(n_types, total_rps, alpha)
    rng = np.random.default_rng(np.random.SeedSequence((seed, 0xF1EE7)))
    jitter = rng.uniform(0.6, 1.4, n_types)
    return [
        FunctionType(
            fn_id=i,
            name=f"fn{i}",
            base_group=i % n_bases,
            rate_rps=float(rates[i]),
            pattern=PATTERNS[i % len(PATTERNS)],
            compute_mean_s=float(compute_mean_s * jitter[i]),
        )
        for i in range(n_types)
    ]


def generate_trace(fleet: Sequence[FunctionType], t_end: float, seed: int = 0,
                   burst_mean_on_s: float = 2.0, burst_mean_off_s: float = 8.0,
                   diurnal_period_s: float = 60.0,
                   max_invocations: Optional[int] = None) -> Trace:
    """The merged fleet trace.  Each function's stream (and its compute
    times) draws from ``SeedSequence(seed, fn_id)``, so the trace is
    bit-identical per seed and independent of fleet iteration order; the
    merge sort is stable with fn_id as tiebreak, so simultaneous arrivals
    order deterministically too."""
    ts: List[np.ndarray] = []
    fns: List[np.ndarray] = []
    comps: List[np.ndarray] = []
    for f in fleet:
        rng = np.random.default_rng(np.random.SeedSequence((seed, f.fn_id)))
        if f.pattern == "poisson":
            a = poisson_arrivals(rng, f.rate_rps, t_end)
        elif f.pattern == "diurnal":
            a = diurnal_arrivals(rng, f.rate_rps, t_end,
                                 period_s=diurnal_period_s)
        elif f.pattern == "onoff":
            a = onoff_arrivals(rng, f.rate_rps, t_end,
                               mean_on_s=burst_mean_on_s,
                               mean_off_s=burst_mean_off_s)
        else:
            raise ValueError(f.pattern)
        if a.size == 0:
            continue
        ts.append(a)
        fns.append(np.full(a.size, f.fn_id, np.int32))
        # lognormal around the function's mean (sigma=0.5 → mild tail)
        comps.append(f.compute_mean_s
                     * rng.lognormal(-0.125, 0.5, a.size))
    if not ts:
        return Trace(np.zeros(0), np.zeros(0, np.int32), np.zeros(0))
    t = np.concatenate(ts)
    fn = np.concatenate(fns)
    comp = np.concatenate(comps)
    order = np.lexsort((fn, t))
    t, fn, comp = t[order], fn[order], comp[order]
    if max_invocations is not None and t.size > max_invocations:
        t, fn, comp = t[:max_invocations], fn[:max_invocations], comp[:max_invocations]
    return Trace(t, fn, comp)
