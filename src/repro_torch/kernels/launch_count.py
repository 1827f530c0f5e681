"""Launch counters of the kernel wrappers.

Each wrapper adds one to its ``<wrapper>.launches`` where it launches its
kernel, and nowhere else.  Restores on a host-wide node server launch from
several host threads at once (the completion worker and each session's own
thread), and ``+=`` on an attribute is a read-modify-write that two threads
can interleave, so every count goes through :func:`count` under one lock.
"""
from __future__ import annotations

import threading

_lock = threading.Lock()


def count(wrapper, attr: str = "launches") -> None:
    """Add one to ``wrapper.<attr>``."""
    with _lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
