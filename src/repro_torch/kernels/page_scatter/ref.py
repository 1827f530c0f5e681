"""Plain torch versions of the in-place row scatter:
``dest[dst[i]] = compact[src[i]]`` (``src`` None means ``i``); rows not named
keep their contents.  ``ops.py`` takes these for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel to them on the card.
"""
from typing import Optional, Sequence

import torch


def page_scatter_ref(dest: torch.Tensor, compact: torch.Tensor, dst: torch.Tensor,
                     src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In place on ``dest`` (N, E); ``dst`` / ``src`` int64 on its device."""
    dest[dst] = compact if src is None else compact[src]
    return dest


def page_scatter_rows_ref(dest: torch.Tensor, segments: Sequence) -> torch.Tensor:
    """The row-list form: for each segment ``(tensor, rows, dst)`` (``rows``
    None: ``arange``), ``dest[dst[k]] = tensor[rows[k]]``, segment by segment."""
    for t, rows, dst in segments:
        idx = torch.as_tensor(dst, dtype=torch.int64, device=dest.device)
        src = None if rows is None else torch.as_tensor(rows, dtype=torch.int64,
                                                        device=dest.device)
        page_scatter_ref(dest, t, idx, src)
    return dest
