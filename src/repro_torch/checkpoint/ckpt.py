"""Aquifer-backed checkpointing: state trees ⇄ paged snapshots.

* **save** — flatten the state tree into named arrays, build a
  ``StateImage`` on the pool's device (tensors already there are copied on
  the device), and publish it to the two-tier pool through the pool master
  (ownership protocol, §3.3): zero pages are dropped, the working set goes
  to CXL, the rest to RDMA.
* **restore** — borrow + clflush + pre-install the hot set, then demand-page
  the cold set; time to hot is recorded apart from time to full, the
  paper's headline effect (resume before the slow tier finishes, §3.4).
  The arrays come back as tensors on the pool's device, views of the
  restored image.

A state tree is nested dicts, lists and tuples of tensors (or numpy
arrays).  Its leaves are named and ordered as ``jax.tree_util`` names and
orders them — dict keys sorted, sequences by index, names the ``"/"``-joined
keys — so the image of a tree is byte-identical to the JAX package's image
of the same tree, manifest included.

Hotness defaults for training state: params hot, Adam moments cold.
Serving-state hotness comes from the offline profiler (core/profiler.py).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import Manifest, Orchestrator, PoolMaster, StateImage
from ..core.profiler import AccessRecorder
from ..tree import children


# --------------------------------------------------------------------------
# state tree <-> named arrays
# --------------------------------------------------------------------------

def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    if tree is None:                      # an empty subtree, as in jax
        return
    kids = children(tree)
    if kids is None:
        yield "/".join(path), tree
        return
    for key, child in kids:
        yield from _leaves(child, path + (key,))


def flatten_state(tree) -> Dict[str, Any]:
    """``{name: array}`` in leaf order; tensors stay tensors, anything else
    becomes a numpy array."""
    return {name: leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            for name, leaf in _leaves(tree)}


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def unflatten_state(template, arrays: Dict[str, Any]):
    """A tree shaped like ``template`` whose leaves are ``arrays[name]`` as
    tensors, reshaped to the template leaves' shapes."""

    def build(node, path: Tuple[str, ...]):
        if node is None:
            return None
        kids = children(node)
        if kids is None:
            arr = arrays["/".join(path)]
            if not isinstance(arr, torch.Tensor):
                arr = torch.from_numpy(np.asarray(arr))
            return arr.reshape(_shape(node))
        built = {key: build(child, path + (key,)) for key, child in kids}
        if isinstance(node, dict):
            return {k: built[str(k)] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(**built)
        return type(node)(built[str(i)] for i in range(len(node)))

    return build(template, ())


# --------------------------------------------------------------------------
# save / restore
# --------------------------------------------------------------------------

def default_train_hotness(manifest: Manifest) -> np.ndarray:
    """Params hot; Adam moments (opt/m, opt/v) cold; step counter hot."""
    rec = AccessRecorder(manifest)
    for e in manifest.extents:
        if not ("/m/" in f"/{e.name}/" or "/v/" in f"/{e.name}/"
                or e.name.startswith(("opt/m", "opt/v", "1/m", "1/v"))):
            rec.touch_array(e.name)
    return rec.working_set()


def save_checkpoint(
    master: PoolMaster,
    name: str,
    state,
    step: int,
    working_set: Optional[Sequence[int]] = None,
    metadata: Optional[dict] = None,
) -> Tuple[StateImage, dict]:
    """Publish ``state`` as snapshot ``name``. Returns (image, stats)."""
    arrays = flatten_state(state)
    image = StateImage.build(arrays, device=master.pool.device)
    if working_set is None:
        working_set = default_train_hotness(image.manifest)
    meta = {"step": step, **(metadata or {})}
    t0 = time.perf_counter()
    regions = master.publish(name, image, working_set, metadata=meta)
    stats = {
        "publish_s": time.perf_counter() - t0,
        "total_pages": regions.total_pages,
        "zero": regions.n_zero,
        "hot": regions.n_hot,
        "cold": regions.n_cold,
        "cxl_bytes": regions.cxl_size,
        "rdma_bytes": regions.rdma_size,
    }
    return image, stats


def restore_checkpoint(
    orch: Orchestrator,
    name: str,
    template,
) -> Tuple[Any, dict]:
    """Borrow + restore ``name``; returns (state, stats).

    The hot set is pre-installed from the CXL tier; every page still absent
    is then touched, so cold pages are demand-paged from the RDMA tier (or
    ride the orchestrator's cold prefetch).  Time to hot is recorded apart
    from time to full.  The state's leaves are tensors on the pool's device,
    views of the restored image.  Beside the reference's stats, ``walk_routes``
    and ``flushes`` say how the bulk walks ran (``RestoreEngine.walk_routes``,
    ``Instance.flushes``).
    """
    t0 = time.perf_counter()
    ri = orch.restore(name)
    if ri is None:
        raise FileNotFoundError(f"no published snapshot named {name!r}")
    t_hot = time.perf_counter() - t0

    # demand-page everything else (the async RDMA engine fills; the touch forces it)
    for page in range(ri.instance.image.total_pages):
        if not ri.instance.present[page]:
            ri.engine.access(page)
    t_full = time.perf_counter() - t0

    manifest, meta = ri.engine.reader.machine_state()
    arrays = {e.name: ri.instance.image.read_tensor(e.name) for e in manifest.extents}
    state = unflatten_state(template, arrays)
    stats = {
        "time_to_hot_s": t_hot,
        "time_to_full_s": t_full,
        "modeled": dict(ri.ledger.seconds),
        "instance": dict(ri.instance.stats),
        "meta": meta,
        # the port's batched walks: routes taken and launches of queued rows
        "walk_routes": ri.engine.walk_routes,
        "flushes": ri.instance.flushes,
    }
    ri.shutdown()
    return state, stats


def reshard(state, mesh, spec_tree):
    """Elastic restore: place a restored state onto a (new) mesh.  Each leaf
    is distributed with the placements ``named`` gives its spec, onto the
    mesh's device type; the leaves come back as DTensors (on a size-1 mesh
    ``.to_local()`` is the whole tensor, bit for bit)."""
    from torch.distributed.tensor import distribute_tensor

    from ..sharding.partition import map_specs, placements

    def put(spec, x):
        x = x.to(mesh.device_type) if x.device.type != mesh.device_type else x
        return distribute_tensor(x, mesh, list(placements(mesh, spec)))

    return map_specs(put, spec_tree, state)
