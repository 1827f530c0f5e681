"""Launch counters of the kernel wrappers.

Each wrapper adds one to its ``<wrapper>.launches`` where it launches its
kernel, and nowhere else, through :func:`count`: the port's counter
primitive (``core.trace.bump``), which takes a lock because restores on a
host-wide node server launch from several host threads at once.  The
launch counters count whether tracing is on or not.
"""
from __future__ import annotations

from ..core.trace import bump as count  # noqa: F401
