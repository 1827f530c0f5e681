"""Spans and counters of the port: one facility, off by default.

A *span* is a named interval of host time on one thread:
``(name, req, parent, thread, t0_ns, t1_ns, cpu_ns)``.  ``parent`` is the
index of the innermost span that was open on the same thread when it began
(None for a root), ``req`` the request it serves, and ``cpu_ns`` the
thread's CPU time inside it (None unless the span asked for it).  A
*counter* is a named integer in the facility's registry.

* Off (the default), :func:`span` returns one shared null context: no
  allocation, no clock read; :func:`count` returns at once.
* :func:`enable` / :func:`disable` switch recording; :func:`reset` drops
  what was recorded; :func:`snapshot` merges every thread's spans.
* :func:`add` records a span whose start was taken on another thread (a
  queue's wait: submitted there, dequeued here).
* :func:`bump` adds one to an attribute under the registry's lock, always,
  whether tracing is on or not: the kernel wrappers' ``launches`` counters.

The clock is :func:`time.time_ns`, the base of the torch profiler's device
events, so a span can be laid over the device's timeline.  It is real time
even under the simulator's virtual clock (``core.clock``): the facility
measures the program, not the model of the hardware.

Spans go to lists of the recording thread (no lock on the path): one of
their names and one of their numbers, flat, so a span keeps no object the
cyclic collector tracks.  (A tuple a span, kept, counts towards the
collector's young generation: ~12k a cold start made its young collections
run often enough to promote the walks' queued batches, and doubled the
full collections of a benchmark window.)  Past :data:`CAP` spans a window,
further spans are counted in ``dropped`` and not kept.  The request id is a context variable, :data:`REQ`, which
``Orchestrator.restore`` sets for its thread; threads of the node server
pass the session's ``req`` themselves.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time

CAP = 4_000_000
_time_ns, _thread_time_ns = time.time_ns, time.thread_time_ns
_NONE = -1                           # None among a span's numbers
_FIELDS = 6                          # index, req, parent, t0_ns, t1_ns, cpu_ns

REQ: contextvars.ContextVar = contextvars.ContextVar("repro_torch_trace_req", default=None)

_on = False
_lock = threading.Lock()
_local = threading.local()
_threads: list = []                  # every recording thread's _Thread since the last reset
_counters: dict = {}
_seq = itertools.count()             # spans begun since the last reset (atomic next)


class _Null:
    """The context :func:`span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Thread:
    __slots__ = ("ident", "names", "nums", "stack", "dropped")

    def __init__(self):
        self.ident = threading.get_ident()
        self.names: list = []        # a span's name, by index; None while it is open
        self.nums: list = []         # _FIELDS numbers a finished span
        self.stack: list = []        # indices of the open spans
        self.dropped = 0


def _thread() -> _Thread:
    try:
        return _local.st
    except AttributeError:
        st = _local.st = _Thread()
        with _lock:
            _threads.append(st)
        return st


class _Span:
    __slots__ = ("name", "req", "cpu", "st", "i", "t0", "c0")

    def __init__(self, name: str, req, cpu: bool):
        self.name, self.req, self.cpu = name, req, cpu

    def __enter__(self):
        try:
            st = self.st = _local.st
        except AttributeError:
            st = self.st = _thread()
        if next(_seq) >= CAP:
            st.dropped += 1
            self.i = None
            return self
        self.i = len(st.names)
        st.names.append(None)
        st.stack.append(self.i)
        # the CPU clock is read inside the wall clock's reads: CPU <= wall
        self.t0 = _time_ns()
        self.c0 = _thread_time_ns() if self.cpu else 0
        return self

    def __exit__(self, *exc):
        if self.i is None:
            return False
        cpu = _thread_time_ns() - self.c0 if self.cpu else _NONE
        t1 = _time_ns()
        st = self.st
        st.stack.pop()
        req = REQ.get() if self.req is None else self.req
        st.nums.extend((self.i, _NONE if req is None else req,
                        st.stack[-1] if st.stack else _NONE, self.t0, t1, cpu))
        st.names[self.i] = self.name
        return False


def span(name: str, req=None, cpu: bool = False):
    """A context manager recording a span ``name``; ``req`` defaults to
    :data:`REQ`, ``cpu`` also records the thread's CPU time (coarse spans
    only: it reads a second clock at each end)."""
    if not _on:
        return _NULL
    return _Span(name, req, cpu)


def now() -> int:
    """``time.time_ns()`` while tracing is on, else 0: a timestamp that
    rides in a queue's entry for :func:`add`."""
    return time.time_ns() if _on else 0


def add(name: str, t0_ns: int, t1_ns: int, req=None) -> None:
    """Record a finished span begun on another thread (no parent)."""
    if not _on or not t0_ns:
        return
    st = _thread()
    if next(_seq) >= CAP:
        st.dropped += 1
        return
    st.nums.extend((len(st.names), _NONE if req is None else req, _NONE, t0_ns, t1_ns, _NONE))
    st.names.append(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def bump(obj, attr: str = "launches") -> None:
    """Add one to ``obj.<attr>``, tracing on or off.  Threads that launch at
    once (a node server's completion worker and each session's own thread)
    would lose updates to ``+=`` on an attribute, so it takes the lock."""
    with _lock:
        setattr(obj, attr, getattr(obj, attr) + 1)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drop every span and counter recorded so far.  A span still open
    finishes into the dropped record."""
    global _local, _threads, _seq
    with _lock:
        _local, _threads, _seq = threading.local(), [], itertools.count()
        _counters.clear()


def snapshot() -> dict:
    """``{"spans": [...], "counters": {...}, "dropped": n}``: every finished
    span of every thread (a thread's in the order it began them; ``parent``
    an index into this list), the counters, and the spans past the cap."""
    with _lock:
        threads, counters = list(_threads), dict(_counters)
    spans, dropped = [], 0
    for st in threads:
        nums, names = list(st.nums), list(st.names)
        dropped += st.dropped
        rows = sorted(nums[k:k + _FIELDS] for k in range(0, len(nums) - len(nums) % _FIELDS,
                                                          _FIELDS))
        where = {}
        for i, req, parent, t0, t1, cpu in rows:
            where[i] = len(spans)
            spans.append((names[i], None if req == _NONE else req, where.get(parent), st.ident,
                          t0, t1, None if cpu == _NONE else cpu))
    return {"spans": spans, "counters": counters, "dropped": dropped}
