"""Device meshes over ``torch.distributed``: the twin of the JAX package's
``launch/mesh.py``.

Single pod: 16x16 = 256 ranks, axes (data, model).
Multi-pod:  2x16x16 = 512 ranks, axes (pod, data, model) — the pod axis
carries cross-DCN data parallelism; Aquifer's pool hierarchy maps onto it
(pod-local CXL tier ↔ intra-pod, RDMA tier ↔ cross-pod).

Defined as functions, and importing this module touches no process-group
state: a mesh is built over the default group, which the caller starts (a
real one on a cluster, a fake one for the dry run: :func:`fake_world`) or
:func:`make_host_mesh` starts with one rank.  :func:`host_mesh` and
:func:`fake_world` destroy the default group they started when their
``with`` block ends; a group left behind would be the next caller's default
group in the same process.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch.distributed as dist

from ..core.pagestore import resolve_device


def _mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if world < math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the default "
                         f"group has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) on ("data", "model"), or (2, 16, 16) on ("pod", "data",
    "model"), over the default group, which must have that many ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs a default process group of 256 "
                           "(512 multi-pod) ranks: a cluster's, or fake_world()'s")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, _device_type())


def make_host_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A small (data, model) mesh over the ranks that exist, clipped to them
    as the reference clips to ``jax.devices()``.  Without a default group it
    starts a one-rank group first (gloo on the CPU, NCCL on the card), so
    on one card the mesh is (1, 1).  ``"cuda"`` without a card raises."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // max(1, data)))
    return _mesh((data, model), ("data", "model"), dev.type)


@contextlib.contextmanager
def host_mesh(data: int = 1, model: int = 1, device="cuda") -> Iterator:
    """:func:`make_host_mesh` for a ``with`` block: the default group is
    destroyed at its end when this call started it."""
    started = not dist.is_initialized()
    try:
        yield make_host_mesh(data, model, device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A default group of ``world_size`` fake ranks, this process rank 0, for
    the ``with`` block: collectives return at once and move nothing (the dry
    run's stand-in for a cluster).  Refuses to start over an existing group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()

