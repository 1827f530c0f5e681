"""Operation, byte and collective counter for a traced torch program: the
port's counterpart of the JAX package's ``roofline/hlo_analyzer.py``.

The reference re-derives the roofline inputs from a compiled program's
optimized HLO text.  Eager torch compiles nothing, so :class:`OpCounter`
is a ``TorchDispatchMode`` that counts the aten ops one device runs while a
program is traced (on ``meta`` tensors in the dry run: shapes, no data),
by the reference's rules:

  * products (mm, bmm, addmm, baddbmm, convolution): 2 × |output| × K;
  * elementwise ops and transcendentals: 1 per output element; a composite
    aten op counts the elementwise and reduction ops XLA would run for it
    (``_softmax`` = 2 reductions + 3 elementwise, ``silu`` = 2, ...);
  * reductions: max(input bytes / 4, |output|);
  * moves (copies, casts, concatenations, fills) and slices (gather, index,
    scatter): bytes only — a slice 2 × its output's bytes, as the reference
    counts dynamic-slice and gather; views move nothing and cost nothing;
  * collectives (``_c10d_functional.*`` and ``c10d.*``): their operand bytes,
    by the reference's five kinds.  A CPU fake group (the dry run's) lowers
    all-to-all as all-gather plus chunk, so its all-to-alls count as
    all-gathers.

Bytes are counted at each counted op's operands and outputs.  Eager torch
fuses nothing, so the byte count is an upper bound on what XLA's fused
program (bytes at fusion boundaries only) would move.

Per device.  Over DTensors the counter steps aside at the DTensor level
(``NotImplemented``, as ``CommDebugMode`` does) and counts the local ops
DTensor issues on its shards, with the collectives of its redistributions.
A local op's shapes are the shard's, so each op counts its DTensor-level
work divided by the product of the mesh dims over which its output is
``Shard`` or ``Partial``; replicated mesh dims repeat the work on every
device and count it whole.  Where a dim does not divide, rank 0 holds the
larger shard (as XLA pads every shard to it) and is the rank counted.  The
ops DTensor runs on fake tensors to propagate shardings are not counted.

``peak_live_bytes`` is the high-water mark of the bytes of storages that
counted ops allocated while the counter was on, each freed when its last
reference (a view, autograd's saved tensors) goes: the dry run's
``temp_bytes``.
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")

_COLLECTIVES = {
    # _c10d_functional (DTensor's redistributions, functional collectives)
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    # c10d (the eager collectives of torch.distributed)
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv", "dot", "matmul",
             "convolution", "_convolution"}
# ops that allocate or bookkeep and move no data
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
         "lift_fresh", "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
         "set_", "resize_", "_has_compatible_shallow_copy_type", "is_same_size",
         "_to_copy_meta", "sym_size", "sym_stride", "sym_numel"}
# bytes = 2 x the output's: the slice read and written
_SLICEY = {"index", "index_select", "gather", "embedding", "take_along_dim", "take",
           "scatter", "scatter_add", "scatter_reduce", "index_add", "index_put",
           "index_copy", "index_fill", "slice_scatter", "select_scatter", "masked_scatter",
           "diagonal_scatter", "as_strided_scatter", "embedding_dense_backward"}
# (reductions, elementwise passes) a composite aten op stands for
_COMPOSITE = {
    "_softmax": (2, 3), "_log_softmax": (2, 3),
    "_softmax_backward_data": (1, 3), "_log_softmax_backward_data": (1, 3),
    "logsumexp": (2, 2),
}
_ELEMENTWISE_COST = {
    "silu": 2, "silu_backward": 6, "softplus": 3, "softplus_backward": 4,
    "sigmoid_backward": 3, "tanh_backward": 3, "gelu": 8, "gelu_backward": 12,
    "addcmul": 2, "addcdiv": 2, "lerp": 2, "threshold_backward": 2,
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all", "argmax",
               "argmin", "norm", "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
               "count_nonzero", "aminmax", "nansum"}
_FILLS = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like", "new_zeros",
          "new_ones", "new_full", "fill", "zero", "arange", "linspace", "scalar_tensor",
          "tril_indices", "triu_indices"}
# copies, casts, concatenations and reorderings: bytes only
_MOVES = {"_to_copy", "copy", "clone", "cat", "stack", "constant_pad_nd", "repeat", "flip",
          "roll", "sort", "argsort", "topk", "expand_copy", "_unsafe_view", "alias",
          "split_with_sizes_copy", "unbind_copy", "permute_copy", "transpose_copy",
          "view_copy", "slice_copy", "select_copy", "split_copy", "contiguous"}
# 1 per output element, as elementwise ops
_SCANS = {"cumsum", "cumprod", "tril", "triu"}
_POINTWISE = getattr(torch.Tag, "pointwise", None)
_REDUCTION = getattr(torch.Tag, "reduction", None)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _fake_mode_active() -> bool:
    """True while DTensor propagates shardings on fake tensors."""
    key = getattr(torch._C._TorchDispatchModeKey, "FAKE", None)
    return key is not None and torch._C._get_dispatch_mode(key) is not None


class OpCounter(TorchDispatchMode):
    """Counts the ops run inside its ``with`` block (see the module
    docstring); :meth:`record` gives ``analyze_hlo``'s keys.  With a
    ``device``, only ops on tensors of that device type count (the dry run
    counts ``meta``: DTensor computes shard sizes with ops on small CPU
    tensors the first time it meets a layout, which the program does not
    run)."""

    def __init__(self, device=None):
        super().__init__()
        self.device = None if device is None else torch.device(device).type
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.n_ops = 0
        self.flops_by_op: Dict[str, float] = collections.Counter()
        self.uncounted: Dict[str, int] = collections.Counter()
        self.live_bytes = 0
        self.peak_live_bytes = 0

    # -- dispatch ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor desugar into local ops and collectives
        out = func(*args, **kwargs)
        if not _fake_mode_active():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if self.device is not None and any(t.device.type != self.device for t in ins + outs):
            return
        name = func._overloadpacket.__name__
        self.n_ops += 1
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                ob = float(sum(_nbytes(t) for t in ins))
                self.coll[kind] += ob
                self.bytes += ob + sum(_nbytes(t) for t in outs)
            self._track(func, outs)
            return
        base = name[:-1] if name.endswith("_") and not name.startswith("_") else name
        if func.is_view or base in _FREE:
            return
        self._track(func, outs)
        out_elems = float(sum(t.numel() for t in outs))
        out_bytes = float(sum(_nbytes(t) for t in outs))
        in_bytes = float(sum(_nbytes(t) for t in ins))
        flops = 0.0
        tags = func.tags
        if base in _PRODUCTS:
            flops = self._product_flops(base, ins, outs)
            self.bytes += out_bytes + in_bytes
        elif base in _SLICEY:
            self.bytes += 2.0 * out_bytes
        elif base in _COMPOSITE:
            n_red, n_elem = _COMPOSITE[base]
            first = ins[0]
            flops = n_red * max(_nbytes(first) / 4.0, out_elems) + n_elem * first.numel()
            self.bytes += out_bytes + in_bytes
        elif base in _REDUCTIONS or (_REDUCTION is not None and _REDUCTION in tags):
            first = _nbytes(ins[0]) if ins else 0
            flops = max(first / 4.0, out_elems)
            self.bytes += out_bytes + first
        elif base in _ELEMENTWISE_COST:
            flops = _ELEMENTWISE_COST[base] * out_elems
            self.bytes += out_bytes + in_bytes
        elif base in _MOVES:
            self.bytes += out_bytes + in_bytes
        elif base in _FILLS:
            self.bytes += out_bytes
        elif base in _SCANS or (_POINTWISE is not None and _POINTWISE in tags):
            flops = out_elems
            self.bytes += out_bytes + in_bytes
        else:
            self.uncounted[name] += 1        # bytes only; the names kept in ``uncounted``
            self.bytes += out_bytes + in_bytes
        if flops:
            self.flops += flops
            self.flops_by_op[name] += flops

    @staticmethod
    def _product_flops(base: str, ins, outs) -> float:
        out_elems = float(sum(t.numel() for t in outs))
        if base in ("convolution", "_convolution"):
            w = ins[1]
            k = w.numel() // max(1, w.shape[0])
        elif base in ("addmm", "baddbmm", "addbmm", "addmv"):
            k = ins[1].shape[-1]
        else:
            k = ins[0].shape[-1]
        flops = 2.0 * out_elems * max(1, k)
        if base in ("addmm", "baddbmm", "addbmm", "addmv"):
            flops += out_elems           # the added term
        return flops

    # -- live bytes ------------------------------------------------------------

    def _track(self, func, outs) -> None:
        """Adds the storages the op allocated to the live bytes until freed
        (a view's or an in-place op's output allocates nothing)."""
        if any(r.alias_info is not None for r in func._schema.returns):
            return
        for t in outs:
            st = t.untyped_storage()
            n = st.nbytes()
            if n == 0 or getattr(st, "_op_counter_tracked", False):
                continue
            st._op_counter_tracked = True
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(st, self._free, weakref.ref(self), n)

    @staticmethod
    def _free(ref, n: int) -> None:
        self = ref()
        if self is not None:
            self.live_bytes -= n

    # -- results -------------------------------------------------------------

    def record(self) -> Dict[str, float]:
        """``analyze_hlo``'s keys (``flops``, ``bytes``, ``coll_<kind>``,
        ``collective_bytes``) plus ``peak_live_bytes`` and ``ops``."""
        out = {"flops": self.flops, "bytes": self.bytes}
        for k in COLLECTIVE_KINDS:
            out[f"coll_{k}"] = self.coll[k]
        out["collective_bytes"] = sum(self.coll.values())
        out["peak_live_bytes"] = float(self.peak_live_bytes)
        out["ops"] = float(self.n_ops)
        return out
