"""Carry images, pools and snapshot records across from plain host data.

These functions take and return plain dicts and numpy arrays, so a snapshot
that another implementation of the same format published (its manifest
dict, image bytes, tier arenas, free lists and region record) can be
restored here, and the other way round.  They import nothing but this
package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.pagestore import Manifest, StateImage
from .core.pool import HierarchicalPool, MemoryTier
from .core.snapshot import SnapshotRegions

FreeLists = Dict[str, List[Tuple[int, int]]]


def state_image_from_numpy(manifest_dict: dict, buf: np.ndarray, device="cuda") -> StateImage:
    """A ``StateImage`` on ``device`` from ``Manifest.to_dict()`` and its bytes."""
    raw = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    img = StateImage.empty_like(Manifest.from_dict(manifest_dict), device=device)
    img.buf.copy_(torch.from_numpy(raw))
    return img


def state_image_to_numpy(image: StateImage) -> Tuple[dict, np.ndarray]:
    """Inverse of :func:`state_image_from_numpy`: ``(manifest_dict, bytes)``."""
    return image.manifest.to_dict(), image.buf.cpu().numpy()


def _load_tier(tier: MemoryTier, buf: np.ndarray, free: List[Tuple[int, int]]) -> None:
    raw = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    if raw.size != tier.capacity:
        raise ValueError(f"tier {tier.name}: {raw.size} bytes for capacity {tier.capacity}")
    tier.buf.copy_(torch.from_numpy(raw))
    blocks = sorted((int(o), int(s)) for o, s in free)
    tier._free = blocks
    tier.bytes_in_use = tier.capacity - sum(s for _o, s in blocks)


def pool_from_numpy(cxl_buf: np.ndarray, rdma_buf: np.ndarray, free_lists: FreeLists,
                    device="cuda", **pool_kwargs) -> HierarchicalPool:
    """A pool on ``device`` holding the given tier arenas and allocator state
    (``free_lists = {"cxl": [(offset, size), ...], "rdma": [...]}``)."""
    pool = HierarchicalPool(cxl_capacity=int(np.asarray(cxl_buf).nbytes),
                            rdma_capacity=int(np.asarray(rdma_buf).nbytes),
                            device=device, **pool_kwargs)
    _load_tier(pool.cxl, cxl_buf, free_lists["cxl"])
    _load_tier(pool.rdma, rdma_buf, free_lists["rdma"])
    return pool


def pool_to_numpy(pool: HierarchicalPool) -> Tuple[np.ndarray, np.ndarray, FreeLists]:
    """Inverse of :func:`pool_from_numpy`: ``(cxl_buf, rdma_buf, free_lists)``."""
    return (pool.cxl.buf.cpu().numpy(), pool.rdma.buf.cpu().numpy(),
            {"cxl": pool.cxl.free_list(), "rdma": pool.rdma.free_list()})


def regions_from_dict(d: dict, page_checksums: Optional[np.ndarray] = None) -> SnapshotRegions:
    """A region record from ``SnapshotRegions.to_dict()``; ``page_checksums``
    (host uint32, guest-indexed) is attached as the in-memory checksum table,
    an int32 tensor of the same bits (a bound scatter moves it to its
    device on first use)."""
    regions = SnapshotRegions.from_dict(dict(d))
    if page_checksums is not None:
        bits = np.asarray(page_checksums, dtype=np.uint32).view(np.int32)
        regions.page_checksums = torch.from_numpy(bits.copy())
    return regions


def regions_to_dict(regions: SnapshotRegions) -> Tuple[dict, Optional[np.ndarray]]:
    """Inverse of :func:`regions_from_dict`: ``(dict, page_checksums uint32 or None)``."""
    cs = getattr(regions, "page_checksums", None)
    return regions.to_dict(), (None if cs is None else cs.cpu().numpy().view(np.uint32))
