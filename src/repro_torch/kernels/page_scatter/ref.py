"""Plain torch version of the in-place row scatter:
``dest[dst[i]] = compact[src[i]]`` (``src`` None means ``i``); rows not named
keep their contents.  ``ops.py`` takes this for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel to it on the card.
"""
from typing import Optional

import torch


def page_scatter_ref(dest: torch.Tensor, compact: torch.Tensor, dst: torch.Tensor,
                     src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In place on ``dest`` (N, E); ``dst`` / ``src`` int64 on its device."""
    dest[dst] = compact if src is None else compact[src]
    return dest
