"""Spans, percentiles and the reduction of a profiler trace.

The harness records a span around each call into a layer of the program
(``Spans``); a traced run also holds the profiler's device events.  Both
use the wall clock in nanoseconds (the profiler's own time base), so a gap
on the device can be labelled with the spans the host was inside.
"""
from __future__ import annotations

import threading
import time
from collections import Counter


def percentile(xs, q: float):
    """The q-th percentile by linear interpolation (numpy's default), or
    None for no samples."""
    xs = sorted(xs)
    if not xs:
        return None
    k = (len(xs) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


class Spans:
    """Thread-safe record of named spans: ``(name, start_ns, end_ns)``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.rows: list = []

    def add(self, name: str, t0_ns: int, t1_ns: int) -> None:
        with self._lock:
            self.rows.append((name, t0_ns, t1_ns))

    def span(self, name: str):
        return _Span(self, name)

    def by_name(self, t_lo: int = 0, t_hi: int = 1 << 62) -> dict:
        """Durations in seconds of every span that ended inside [t_lo, t_hi],
        by name."""
        out: dict = {}
        with self._lock:
            for n, a, b in self.rows:
                if t_lo <= b <= t_hi:
                    out.setdefault(n, []).append((b - a) / 1e9)
        return out


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if exc[0] is None:
            self.spans.add(self.name, self.t0, self.t1)
        return False


def device_events(prof) -> list:
    """``(name, start_ns, end_ns)`` of every kernel, copy and memset in a
    ``torch.profiler`` trace, read once from its raw events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def union(intervals) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(events: list, t0_ns: int, t1_ns: int, spans: Spans, top: int = 10) -> dict:
    """Busy seconds (the union of device intervals inside the window), the
    window's seconds, device seconds by name, and the longest idle gaps,
    each labelled with the span the host's clients were most often inside
    at its middle."""
    clipped = [(n, max(a, t0_ns), min(b, t1_ns)) for n, a, b in events if b > t0_ns and a < t1_ns]
    busy = union((a, b) for _, a, b in clipped)
    by_name = Counter()
    for n, a, b in clipped:
        by_name[n] += (b - a) / 1e9
    gaps, prev = [], t0_ns
    for a, b in busy + [[t1_ns, t1_ns]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    with spans._lock:
        rows = list(spans.rows)
    labelled = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        inside = Counter(n for n, s, e in rows if s <= mid <= e)
        label = inside.most_common(1)[0][0] if inside else "outside spans"
        labelled.append([label, (b - a) / 1e9])
    return {"busy_s": sum(b - a for a, b in busy) / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
            "by_name": dict(by_name),
            "device_ops": [[n, s] for n, s in by_name.most_common(top)],
            "idle_gaps": labelled}
