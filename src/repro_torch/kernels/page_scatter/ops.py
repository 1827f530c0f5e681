"""Dispatch wrapper for the in-place row scatter.

``page_scatter(dest, compact, indices, src_indices=None)`` writes
``dest[indices[i]] = compact[src_indices[i]]`` in place (``src_indices``
None means ``i``) and returns ``dest``: the serving layer's ``ScatterFn``
contract, so it plugs in there as it is.  Indices are host integer arrays
(range-checked, copied to the card once; destinations checked unique in
debug mode) or int64 tensors already on ``dest``'s device.  CPU tensors take
the plain version (``ref.py``); CUDA tensors launch the hand-written kernel
or raise.  ``page_scatter.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import rows
from . import kernel
from .ref import page_scatter_ref


def page_scatter(dest: torch.Tensor, compact: torch.Tensor, indices,
                 src_indices=None) -> torch.Tensor:
    """dest: (N, E) written in place; compact: (C, E) of dest's dtype."""
    if dest.dim() != 2 or compact.dim() != 2 or dest.shape[1] != compact.shape[1] \
            or dest.dtype != compact.dtype:
        raise ValueError(f"page_scatter: dest {tuple(dest.shape)} {dest.dtype} and compact "
                         f"{tuple(compact.shape)} {compact.dtype} rows differ")
    dst = rows.as_index_tensor("page_scatter", indices, dest.shape[0], dest.device)
    src = (None if src_indices is None else
           rows.as_index_tensor("page_scatter src", src_indices, compact.shape[0], dest.device))
    m = dst.shape[0]
    if (src.shape[0] if src is not None else compact.shape[0]) != m:
        raise ValueError(f"page_scatter: {m} destinations for "
                         f"{compact.shape[0] if src is None else src.shape[0]} sources")
    rows.check_unique("page_scatter", indices)
    if m == 0:
        return dest
    if dest.device.type == "cpu":
        return page_scatter_ref(dest, compact, dst, src)
    rows.check_rows("page_scatter dest", dest)
    rows.check_rows("page_scatter compact", compact)
    with torch.cuda.device(dest.device):
        kernel.page_scatter(dest, compact, dst, src)
    page_scatter.launches += 1
    return dest


page_scatter.launches = 0
