"""Plain torch version of zero-page detection.

    zero[i] = 1  where every element of row i equals zero by value

for an ``(N, E)`` tensor of any dtype, as int32.  Values, not bits: a float
row of -0.0 counts as zero, NaN does not.  ``ops.py`` takes this for CPU
tensors, and ``chip_smoke.py`` holds the CUDA kernel to it on the card.
"""
import torch


def zero_detect_ref(pages: torch.Tensor) -> torch.Tensor:
    """pages: (N, E) any dtype -> int32[N], 1 where the row is all zero."""
    if pages.dtype.is_floating_point or pages.dtype.is_complex:
        return (pages == 0).all(dim=1).to(torch.int32)
    return pages.any(dim=1).logical_not().to(torch.int32)   # integers: by value = by bits
