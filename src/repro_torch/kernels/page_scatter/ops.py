"""Dispatch wrappers for the in-place row scatter.

``page_scatter(dest, compact, indices, src_indices=None)`` writes
``dest[indices[i]] = compact[src_indices[i]]`` in place (``src_indices``
None means ``i``) and returns ``dest``: the serving layer's ``ScatterFn``
contract, so it plugs in there as it is.  Indices are host integer arrays
(then it is :func:`page_scatter_rows` of one segment) or int64 tensors
already on ``dest``'s device, which the kernel takes as they are.

``page_scatter_rows(dest, segments)`` is its batched form over a row list
(``rows.py``): one launch for rows of many source tensors, which is how the
serving layer installs a whole restore walk (``page_scatter.scatter_rows``).

CPU tensors take the plain versions (``ref.py``); CUDA tensors launch the
hand-written kernel or raise.  ``page_scatter.launches`` counts kernel
launches of both forms.
"""
from __future__ import annotations

import torch

from .. import launch_count, rows
from . import kernel
from .ref import page_scatter_rows_ref


def _row_bytes(t: torch.Tensor) -> int:
    return t.shape[1] * t.element_size()


def page_scatter(dest: torch.Tensor, compact: torch.Tensor, indices,
                 src_indices=None) -> torch.Tensor:
    """dest: (N, E) written in place; compact: (C, E) of dest's dtype."""
    if dest.dim() != 2 or compact.dim() != 2 or dest.shape[1] != compact.shape[1] \
            or dest.dtype != compact.dtype:
        raise ValueError(f"page_scatter: dest {tuple(dest.shape)} {dest.dtype} and compact "
                         f"{tuple(compact.shape)} {compact.dtype} rows differ")
    if not any(isinstance(i, torch.Tensor) and i.device.type != "cpu"
               for i in (indices, src_indices)):
        return page_scatter_rows(dest, [(compact, src_indices, indices)])
    # indices on the card: the kernel reads compact by base + row index
    dst = rows.as_index_tensor("page_scatter", indices, dest.shape[0], dest.device)
    src = (None if src_indices is None else
           rows.as_index_tensor("page_scatter src", src_indices, compact.shape[0], dest.device))
    n_src = compact.shape[0] if src is None else src.shape[0]
    if n_src != dst.shape[0]:
        raise ValueError(f"page_scatter: {dst.shape[0]} destinations for {n_src} sources")
    if dst.shape[0] == 0:
        return dest
    rows.check_rows("page_scatter dest", dest)
    rows.check_rows("page_scatter compact", compact)
    with torch.cuda.device(dest.device):
        kernel.scatter_rows(dest, compact.data_ptr(), _row_bytes(compact), src, dst)
    launch_count.count(page_scatter)
    return dest


def page_scatter_rows(dest: torch.Tensor, segments) -> torch.Tensor:
    """For each segment ``(tensor, rows, dst)`` of host arrays, ``dest[dst[k]]
    = tensor[rows[k]]`` (``rows`` None: ``k``), in place, in ONE launch on the
    card; destinations unique across all segments."""
    if dest.dim() != 2:
        raise ValueError(f"page_scatter_rows: dest {tuple(dest.shape)} is not 2-D rows")
    segs, dst, addr = rows.check_segments("page_scatter_rows", segments, _row_bytes(dest),
                                          dest.shape[0])
    for t, _r, _d in segs:
        if t.dtype != dest.dtype or t.device != dest.device:
            raise ValueError(f"page_scatter_rows: a source {t.dtype} on {t.device} for dest "
                             f"{dest.dtype} on {dest.device}")
    if dest.device.type == "cpu":
        return page_scatter_rows_ref(dest, segs)
    if dst.size == 0:
        return dest
    rows.check_rows("page_scatter_rows dest", dest)
    idx = rows.upload([addr, dst], dest.device)
    with torch.cuda.device(dest.device):
        kernel.scatter_rows(dest, 0, 1, idx[0], idx[1])
    launch_count.count(page_scatter)
    return dest


page_scatter.launches = 0
page_scatter.scatter_rows = page_scatter_rows
