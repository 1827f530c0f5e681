"""Plain torch version of the row gather: ``out[i] = pages[indices[i]]``.

``ops.py`` takes this for CPU tensors, and ``chip_smoke.py`` holds the CUDA
kernel to it on the card.
"""
import torch


def page_gather_ref(pages: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """pages: (N, E); indices: int64[M] on pages' device -> (M, E)."""
    return pages[indices]
