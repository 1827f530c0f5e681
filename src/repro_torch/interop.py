"""Carry images, pools, snapshot records, catalogs and model parameters
across from plain host data.

These functions take and return plain dicts and numpy arrays, so a snapshot
that another implementation of the same format published (its manifest
dict, image bytes, tier arenas, free lists, dedup store states, region
record and the pod's catalog) can be restored and freed here, and the other
way round; and a model's parameter tree (nested dicts of arrays under the same names and
shapes) can be loaded here or written out.  They import nothing but this
package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.coherence import STATE_FREE, Catalog
from .core.dedup import DedupStore
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


def dedup_store_state(store: DedupStore) -> dict:
    """A dedup store's state as plain dicts and lists: ``buckets`` (hash ->
    offsets, in bucket order), ``refs`` (offset -> refcount), ``hash_of``
    (offset -> hash), ``quarantined`` (sorted offsets) and ``stats``."""
    with store._lock:
        return {"buckets": {h: list(b) for h, b in store._buckets.items()},
                "refs": dict(store._refs), "hash_of": dict(store._hash_of),
                "quarantined": sorted(store._quarantined), "stats": dict(store.stats)}


def dedup_store_from_state(tier: MemoryTier, state: dict, hash_fn=None) -> DedupStore:
    """A dedup store on ``tier`` (whose arena already holds the pages) with
    the state :func:`dedup_store_state` describes."""
    store = DedupStore(tier, hash_fn=hash_fn)
    store._buckets = {int(h): [int(o) for o in b] for h, b in state["buckets"].items()}
    store._refs = {int(o): int(c) for o, c in state["refs"].items()}
    store._hash_of = {int(o): int(h) for o, h in state["hash_of"].items()}
    store._quarantined = {int(o) for o in state["quarantined"]}
    store.stats.update({k: int(v) for k, v in state["stats"].items()})
    return store


def pool_from_numpy(cxl_buf: np.ndarray, rdma_buf: np.ndarray, free_lists: FreeLists,
                    device="cuda", dedup_states: Optional[Dict[str, dict]] = None,
                    **pool_kwargs) -> HierarchicalPool:
    """A pool on ``device`` holding the given tier arenas and allocator state
    (``free_lists = {"cxl": [(offset, size), ...], "rdma": [...]}``) and,
    when given, the two dedup store states (``{"cxl": state, "rdma": state}``,
    see :func:`dedup_store_state`)."""
    pool = HierarchicalPool(cxl_capacity=int(np.asarray(cxl_buf).nbytes),
                            rdma_capacity=int(np.asarray(rdma_buf).nbytes),
                            device=device, **pool_kwargs)
    _load_tier(pool.cxl, cxl_buf, free_lists["cxl"])
    _load_tier(pool.rdma, rdma_buf, free_lists["rdma"])
    if dedup_states is not None:
        pool.dedup_cxl = dedup_store_from_state(pool.cxl, dedup_states["cxl"],
                                                pool.dedup_cxl.hash_fn)
        pool.dedup_rdma = dedup_store_from_state(pool.rdma, dedup_states["rdma"],
                                                 pool.dedup_rdma.hash_fn)
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


def catalog_state(catalog: Catalog) -> dict:
    """A catalog's shared words as plain data: ``capacity`` and, for every
    entry that is not a never-used FREE slot, its ``index``, ``name``,
    ``state`` word, ``refcount``, ``version`` and ``regions`` (the pair
    :func:`regions_to_dict` gives, or None)."""
    entries = []
    for e in catalog.entries:
        state, refcount = e.state.load(), e.refcount.load()
        if state == STATE_FREE and not refcount and not e.name and e.regions is None:
            continue
        entries.append({"index": e.index, "name": e.name, "state": state,
                        "refcount": refcount, "version": e.version,
                        "regions": None if e.regions is None else regions_to_dict(e.regions)})
    return {"capacity": len(catalog.entries), "entries": entries}


def catalog_from_state(state: dict, clock=None) -> Catalog:
    """A catalog holding what :func:`catalog_state` describes: the same
    entries at the same indices, named entries bound for lookup."""
    catalog = Catalog(capacity=int(state["capacity"]), clock=clock)
    for d in state["entries"]:
        e = catalog.entries[int(d["index"])]
        e.name, e.version = d["name"], int(d["version"])
        e.state.store(int(d["state"]))
        e.refcount.store(int(d["refcount"]))
        if d["regions"] is not None:
            e.regions = regions_from_dict(*d["regions"])
        if e.name:
            catalog._bind(e.name, e.index)
    return catalog


def params_from_numpy(tree, device="cuda"):
    """A parameter tree of tensors on ``device`` from nested dicts/lists of
    numpy arrays (or anything ``np.asarray`` takes): same names, shapes,
    dtypes and bits, copied (no tensor aliases the caller's arrays)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def params_to_numpy(params):
    """Inverse of :func:`params_from_numpy`: nested dicts/lists of host numpy
    arrays with the tensors' bits."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to_numpy(v) for v in params)
    return params.detach().cpu().numpy()
