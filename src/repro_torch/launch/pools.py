"""Pool arenas sized to what a launcher publishes.

The reference's launchers take fixed 1–6 GiB pools of host arrays, which the
host commits only as pages are written.  The port's tier arenas are tensors
allocated whole when the pool is made (on the card by default), so a launcher
sizes them to its snapshots instead: two versions of the state (an update
publishes the new version before it frees the old one), plus slack for the
manifest and offset array.
"""
from __future__ import annotations

from typing import Tuple

from ..configs.base import ModelConfig
from ..core import PAGE_SIZE

_SLACK = 16 << 20


def _pages(nbytes: float) -> int:
    return -(-int(nbytes) // PAGE_SIZE) * PAGE_SIZE


def pool_capacities(cfg: ModelConfig, moments: bool) -> Tuple[int, int]:
    """``(cxl, rdma)`` bytes for two versions of ``cfg``'s float32 parameters
    (hot, in CXL) and, when ``moments``, of its two AdamW moments (cold, in
    RDMA)."""
    params = 4 * 1.05 * cfg.param_count()
    cxl = 2 * _pages(params) + _SLACK
    rdma = 2 * _pages(2 * params if moments else params) + _SLACK
    return cxl, rdma
