"""Sharding rules: parameter, optimizer, cache and batch specs for the
production meshes, and the placements that put them on a ``DeviceMesh``.
The twin of the JAX package's ``sharding/partition.py``.

Scheme (the reference's baseline):
  * 2-D param sharding: FSDP over the ``data`` axis × tensor parallelism
    over the ``model`` axis.  Column-parallel in-projections, row-parallel
    out-projections, vocab-parallel embeddings.
  * MoE experts: expert-parallel over ``model`` (E % 16 == 0 for both MoE
    archs), expert weights additionally FSDP over ``data``.
  * Multi-pod: batch data-parallel over (pod, data); params/optimizer are
    replicated across pods, sharded within a pod.
  * KV caches: batch-sharded where the batch covers the axis; KV heads over
    ``model`` when divisible, else head_dim; long-context batch=1 cells
    shard the sequence axis of the cache over ``data``.

Rules are path-keyed (substring match on '/'-joined param paths, named as
``jax.tree_util`` names them) with the trailing dims of the rule aligned to
the trailing dims of the leaf; leading stack dims (layer, group) are
replicated.

A spec is a :class:`P`, a tuple of per-dim entries (an axis name, a tuple of
names, or None), equal to ``tuple()`` of the reference's ``PartitionSpec``.
:func:`named` turns specs into DTensor placements, one per mesh dim.
:func:`constrain` and :func:`cache_constrain`, the counterparts of
``with_sharding_constraint``, redistribute a DTensor while a mesh is active
(:func:`use_mesh`, the counterpart of ``jax.sharding.set_mesh``) and return
their input unchanged otherwise: on plain tensors and without a mesh they
are the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..tree import children

# (pattern, trailing-dims spec). First match wins; patterns are substrings
# of the '/'-joined path. None spec entry = replicated dim.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings
    ("embed/table", ("model", "data")),        # vocab-parallel
    ("embed/head", ("data", "model")),
    # MoE experts (E, D, F) / (E, F, D) — EP over model, FSDP over data
    ("moe/wi", ("model", "data", None)),
    ("moe/wg", ("model", "data", None)),
    ("moe/wo", ("model", None, "data")),
    ("moe/router", ("data", None)),
    ("moe/shared/wi", ("data", "model")),
    ("moe/shared/wg", ("data", "model")),
    ("moe/shared/wo", ("model", "data")),
    # attention projections
    ("attn/wq", ("data", "model")),
    ("attn/wk", ("data", "model")),
    ("attn/wv", ("data", "model")),
    ("attn/wo", ("model", "data")),
    ("attn/wq_a", ("data", None)),
    ("attn/wq_b", (None, "model")),
    ("attn/wkv_a", ("data", None)),
    ("attn/wkv_b", (None, "model")),
    ("self/w", ("data", "model")),
    ("self/wo", ("model", "data")),
    ("cross/wo", ("model", "data")),
    ("cross/w", ("data", "model")),
    # MLPs
    ("mlp/wi", ("data", "model")),
    ("mlp/wg", ("data", "model")),
    ("mlp/wo", ("model", "data")),
    ("mtp/proj", ("data", None)),
    # SSM / xLSTM
    # fused (z|x|B|C|dt) out dim is not TP-divisible → FSDP only
    ("mamba/in_proj", ("data", None)),
    ("mamba/out_proj", ("model", "data")),
    ("mlstm/wq", ("data", "model")),
    ("mlstm/wk", ("data", "model")),
    ("mlstm/wv", ("data", "model")),
    ("mlstm/wog", ("data", "model")),
    ("mlstm/wo", ("model", "data")),
    ("slstm/wx", ("data", "model")),
    ("slstm/wo", ("model", "data")),
)


class P(tuple):
    """A partition spec: one entry a tensor dim, each an axis name, a tuple
    of axis names (major first) or None (replicated).  A tuple of one name
    is that name and an empty one None, as ``PartitionSpec`` normalizes
    them."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _entry(e):
    if isinstance(e, (tuple, list)):
        return None if not e else e[0] if len(e) == 1 else tuple(e)
    return e


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree's leaves, the path '/'-joined as
    ``jax.tree_util`` keys name it (a NamedTuple field as ``.name``)."""
    kids = children(tree)
    if kids is None:
        return fn(path, tree)
    named_tuple = isinstance(tree, tuple) and hasattr(tree, "_fields")
    out = {k: _map_with_path(fn, v, (path + "/" if path else "")
                             + ("." + k if named_tuple else k)) for k, v in kids}
    if isinstance(tree, dict):
        return {k: out[str(k)] for k in tree}
    if named_tuple:
        return type(tree)(*(out[f] for f in tree._fields))
    return type(tree)(out[str(i)] for i in range(len(tree)))


def map_specs(fn, spec_tree, *rest):
    """``fn(spec, *leaves)`` over a tree of :class:`P` leaves and trees of the
    same structure."""
    if isinstance(spec_tree, P):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest)) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(map_specs(fn, *xs) for xs in zip(spec_tree, *rest)))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(map_specs(fn, *xs) for xs in zip(spec_tree, *rest))
    raise TypeError(f"map_specs: {type(spec_tree).__name__} is neither a P nor a container")


def _spec_for(path: str, ndim: int) -> P:
    for pat, trailing in _PARAM_RULES:
        if pat in path:
            if len(trailing) > ndim:
                return P()
            lead = (None,) * (ndim - len(trailing))
            return P(*lead, *trailing)
    return P()  # norms, biases, scalars: replicated


def param_specs(params) -> Any:
    """Spec tree mirroring ``params`` (axis names: data/model)."""
    return _map_with_path(lambda path, leaf: _spec_for(path, len(leaf.shape)), params)


# --------------------------------------------------------------------------
# meshes: a DeviceMesh, or any object with ``axis_names`` and a ``shape``
# dict (the reference tests' stand-in)
# --------------------------------------------------------------------------

def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes: ('pod','data') on the multi-pod mesh else ('data',)."""
    return tuple(a for a in mesh_shape(mesh) if a in ("pod", "data"))


def _axis_size(shape: Dict[str, int], axes) -> int:
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def batch_specs(batch_tree, mesh) -> Any:
    """Shard the leading (batch) dim over the DP axes where it divides."""
    shape_of = mesh_shape(mesh)
    dp = dp_axes(mesh)
    dpn = _axis_size(shape_of, dp)

    def spec(_, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        if shape[0] % dpn == 0 and shape[0] > 0:
            return P(dp, *(None,) * (len(shape) - 1))
        # small batch: try data-only
        if "data" in shape_of and shape[0] % shape_of["data"] == 0:
            return P("data", *(None,) * (len(shape) - 1))
        return P(*(None,) * len(shape))

    return _map_with_path(spec, batch_tree)


def cache_specs(cache_tree, cfg: ModelConfig, mesh, batch: int) -> Any:
    """Decode-state sharding (see module docstring)."""
    shape_of = mesh_shape(mesh)
    dp = dp_axes(mesh)
    dpn = _axis_size(shape_of, dp)
    tp = shape_of.get("model", 1)
    batch_shardable = batch % dpn == 0

    def spec(p, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        ax: list = [None] * nd
        # locate the batch dim: first dim equal to `batch`
        bdim = next((i for i, s in enumerate(shape) if s == batch and i <= 2), None)
        if bdim is not None and batch_shardable:
            ax[bdim] = dp
        if ("latent" in p) or re.search(r"(^|/)(k|v|cross|self)($|/)", p) or "attn" in p:
            # attention caches: (..., B, H, S, dh) or latent (..., B, S, r)
            if "latent" in p:
                sdim = nd - 2
                if cfg.flash_decoding and shape[sdim] % tp == 0:
                    # flash-decoding layout: sequence over the TP axis
                    ax[sdim] = "model"
                elif ((bdim is None or not batch_shardable)
                      and shape[sdim] % shape_of.get("data", 1) == 0):
                    ax[sdim] = "data"
            else:
                hdim, sdim, ddim = nd - 3, nd - 2, nd - 1
                if shape[hdim] % tp == 0:
                    ax[hdim] = "model"
                elif shape[ddim] % tp == 0:
                    ax[ddim] = "model"
                if ((bdim is None or not batch_shardable)
                        and shape[sdim] % shape_of.get("data", 1) == 0):
                    ax[sdim] = "data"
        return P(*ax)

    return _map_with_path(spec, cache_tree)


# --------------------------------------------------------------------------
# placements
# --------------------------------------------------------------------------

def placements(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a tensor
    dim sharded over several axes gets ``Shard(d)`` on each, which DTensor
    splits in mesh order, so the axes must be named major first, as JAX
    orders them."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]          # ValueError: axis not on the mesh
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def named(mesh, spec_tree):
    """Placements per leaf of ``spec_tree`` (the reference's NamedShardings)."""
    return map_specs(lambda s: placements(mesh, s), spec_tree)


_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@functools.cache
def _register_rules() -> None:
    """Sharding rules DTensor lacks for ops the models run (once a process):
    ``log_sigmoid_backward`` (the mLSTM's forget gate) is elementwise."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad_output, self, buffer):
        rules = [([Replicate()], [Replicate()] * 3)]
        rules += [([Shard(d)], [Shard(d)] * 3) for d in range(self.ndim)]
        return rules


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Makes ``mesh`` the one :func:`constrain` and :func:`cache_constrain`
    read, for the ``with`` block (``jax.sharding.set_mesh``)."""
    _register_rules()
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh():
    return _ACTIVE_MESH.get()


def _to(x, want: tuple):
    """DTensor ``x`` redistributed to the placements ``want`` (no-op when it
    has them)."""
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def _redistribute(x, spec: list):
    """``x`` redistributed to ``spec`` when it is a DTensor and the spec names
    an axis, else ``x``.  An entry whose axes' size does not divide its dim
    degrades to replicated: XLA pads such a shard, DTensor cannot carry an
    uneven one through the views that follow (a decode's single MoE group
    over 16 data ranks)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    sizes = mesh_shape(x.device_mesh)

    def divides(d, a):
        return x.shape[d] % _axis_size(sizes, a if isinstance(a, tuple) else (a,)) == 0

    spec = [a if a is not None and divides(d, a) else None for d, a in enumerate(spec)]
    if not any(spec):
        return x
    return _to(x, placements(x.device_mesh, P(*spec)))


def constrain(x, *axes):
    """``with_sharding_constraint`` on a DTensor while a mesh is active: axes
    not on the mesh degrade to replicated; the identity otherwise."""
    mesh = active_mesh()
    if mesh is None:
        return x
    names = mesh_shape(mesh)
    spec = []
    for a in axes:
        if a is None:
            spec.append(None)
        elif isinstance(a, tuple):
            ok = tuple(ax for ax in a if ax in names)
            spec.append(ok if ok else None)
        else:
            spec.append(a if a in names else None)
    return _redistribute(x, spec)


def gather_dp(x):
    """A parameter about to be used, gathered over the DP axes while a mesh
    is active (FSDP's all-gather before use: XLA's partitioner gathers a
    weight sharded over 'data' whose contraction meets a batch sharded over
    'data'; DTensor would move the activations instead); ``x`` otherwise."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if active_mesh() is None or not isinstance(x, DTensor):
        return x
    names = list(mesh_shape(x.device_mesh))
    want = tuple(Replicate() if isinstance(p, Shard) and names[i] in ("pod", "data") else p
                 for i, p in enumerate(x.placements))
    return _to(x, want)


def local_shards(fn, batched, replicated=(), heads: bool = False, by_head=()):
    """``fn(*batched, *replicated, *by_head)`` on each rank's shards, the
    counterpart of the reference's scans, attention and experts, which XLA
    partitions over the batch (and the heads or experts): while a mesh is
    active and ``batched[0]`` is a DTensor, the ``batched`` tensors are laid
    out batch (dim 0) over the DP axes that divide it, with ``heads`` dim 1
    over 'model' where every one's dim 1 divides, the ``replicated`` ones
    replicated, and the ``by_head`` ones (expert weights) dim 0 over 'model'
    alongside; ``fn`` runs on the local tensors (no DTensor dispatch an op)
    and its output comes back laid out as ``batched[0]``.  A plain call
    otherwise."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    x = batched[0]
    if active_mesh() is None or not isinstance(x, DTensor):
        return fn(*batched, *replicated, *by_head)
    mesh = x.device_mesh
    sizes = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    by_batch = x.shape[0] % _axis_size(sizes, dp) == 0
    by_heads = heads and "model" in sizes and all(t.shape[1] % sizes["model"] == 0
                                                  for t in batched)
    lay = tuple(Shard(0) if by_batch and a in dp else
                Shard(1) if by_heads and a == "model" else Replicate() for a in sizes)
    rep = tuple(Replicate() for _ in sizes)
    head = tuple(Shard(0) if by_heads and a == "model" else Replicate() for a in sizes)
    return local_map(fn, out_placements=list(lay),
                     in_placements=((lay,) * len(batched) + (rep,) * len(replicated)
                                    + (head,) * len(by_head)),
                     device_mesh=mesh, redistribute_inputs=True)(*batched, *replicated,
                                                                 *by_head)


def pin_grad(x):
    """The identity forward; while a mesh is active, ``x``'s gradient is
    laid out as ``x`` was before it flows on.  DTensor lays a gradient out
    by the ops after ``x``, and a reshape's backward then refuses an uneven
    split (a merged head dim, a DP-sharded group of half a sequence); XLA
    reshards there by itself.  ``x`` itself otherwise."""
    from torch.distributed.tensor import DTensor

    if active_mesh() is None or not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _PinGrad.apply(x)


class _PinGrad(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the input."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _to(grad, ctx.placements)


def constrain_like(x, like):
    """``x`` laid out as ``like`` (a gradient as its parameter: partial sums
    reduce-scattered to the parameter's shards, as XLA lays out the
    gradients of sharded parameters) while a mesh is active and both are
    DTensors; ``x`` otherwise."""
    from torch.distributed.tensor import DTensor

    if active_mesh() is None or not isinstance(x, DTensor) or not isinstance(like, DTensor):
        return x
    return _to(x, tuple(like.placements))


def constrain_split(x, n: int, dim: int = -1):
    """Before ``x``'s dim ``dim`` is split into (``n``, -1), as the heads of
    a projection are: while a mesh is active, a DTensor sharded on that dim
    over a mesh dim whose size does not divide ``n`` is gathered on that
    mesh dim (XLA's partitioner reshards there by itself; DTensor's view
    refuses an uneven split).  The identity otherwise."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if active_mesh() is None or not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    mesh = x.device_mesh
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim % x.ndim == dim
                 and n % mesh.size(i) else p for i, p in enumerate(x.placements))
    return _to(x, want)


def constrain_flatten(x, start: int):
    """Before ``x``'s dims ``start`` onwards are flattened into one, as the
    heads of a decode's output are: while a mesh is active, a DTensor
    sharded on one of them but the first is gathered there (DTensor refuses
    to flatten such a dim; XLA's partitioner reshards).  The identity
    otherwise."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if active_mesh() is None or not isinstance(x, DTensor):
        return x
    start %= x.ndim
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim % x.ndim > start else p
                 for p in x.placements)
    return _to(x, want)


def cache_constrain(x, seq_shard: bool = False):
    """In-loop counterpart of cache_specs for a single layer's cache slice:
    batch over DP; for (B,H,S,dh) KV caches, heads over 'model' when
    divisible else head_dim; with ``seq_shard`` a (B, S, r) latent cache's
    sequence over 'model'."""
    mesh = active_mesh()
    if mesh is None:
        return x
    names = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    dpn = _axis_size(names, dp)
    tp = names.get("model", 1)
    nd = x.ndim
    spec: list = [None] * nd
    if dp and x.shape[0] % dpn == 0:
        spec[0] = dp
    if nd == 4 and "model" in names:
        if x.shape[1] % tp == 0:
            spec[1] = "model"
        elif x.shape[3] % tp == 0:
            spec[3] = "model"
    elif nd == 3 and seq_shard and "model" in names and x.shape[1] % tp == 0:
        spec[1] = "model"   # latent cache: sequence over TP (flash-decoding)
    return _redistribute(x, spec)
