"""Plain torch version of the per-page polynomial checksum (poly32).

    h(page) = sum_i lane_i * P^(E-1-i)   (mod 2^32),  P = 0x01000193

over the page's ``E`` little-endian uint32 lanes.  The sum is mod 2^32, so
any summation order is bit-exact as long as every product and partial sum
wraps in 32 bits.  Torch has no usable uint32 arithmetic, so the plain
version computes in int64: the product of two values below 2^32 can exceed
2^63 and wraps, but its low 32 bits stay right; each product is masked to 32
bits *before* the sum over lanes so the sum cannot overflow.  Checksums are
kept as ``int32`` tensors holding the uint32 bits; compare them with
``.cpu().numpy().view(np.uint32)``.
"""
import numpy as np
import torch

POLY_P = np.uint32(0x01000193)  # FNV prime reused as the polynomial base
MASK32 = 0xFFFFFFFF


def poly_weights(n_lanes: int) -> np.ndarray:
    """uint32[n_lanes] = [P^(n-1), ..., P, 1] mod 2^32 (host numpy)."""
    w = np.empty(n_lanes, dtype=np.uint32)
    acc = np.uint32(1)
    with np.errstate(over="ignore"):
        for i in range(n_lanes - 1, -1, -1):
            w[i] = acc
            acc = acc * POLY_P
    return w


def u32_bits_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def page_checksum_ref(pages: torch.Tensor, block_pages: int = 4096) -> torch.Tensor:
    """pages: (N, page_bytes) uint8 -> int32[N] holding the poly32 bits.

    Processed ``block_pages`` rows at a time so the int64 temporaries stay
    bounded (8 bytes per lane) on large images.
    """
    n, page_bytes = pages.shape
    lanes = page_bytes // 4
    w = torch.from_numpy(poly_weights(lanes).astype(np.int64)).to(pages.device)
    out = torch.empty(n, dtype=torch.int32, device=pages.device)
    for r0 in range(0, n, block_pages):
        rows = pages[r0 : r0 + block_pages].contiguous().view(torch.int32)
        prod = (rows.to(torch.int64) & MASK32) * w
        out[r0 : r0 + block_pages] = u32_bits_to_i32((prod & MASK32).sum(dim=1) & MASK32)
    return out
