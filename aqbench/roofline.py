"""The yardstick of the kernel rooflines: the card's peak and the bytes
each kernel's work needs, whatever implements it.

A share is the least time the bytes need at the peak over the kernel's
device time summed from the trace, in percent.  A second pass over the
same rows (a verify-only launch, a re-read) adds time and no bytes.
"""
from __future__ import annotations

PAGE = 4096
# NVIDIA H100 SXM5 data sheet: 3.35 TB/s of HBM3 at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
# the kernels' device names in a profiler trace (row_copy.cuh's persistent
# row kernel: fused_restore launches the checksum form, page_scatter the
# plain copy; fused_publish.cu's one-pass kernel)
KERNEL_NAMES = {"fused_restore": ("rows_kernel<true>",),
                "fused_publish": ("publish_kernel",)}


def restore_bytes(pages: int) -> int:
    """A verified install: each page's 4 KiB read and written once, and its
    4-byte expected checksum read."""
    return pages * (2 * PAGE + 4)


def publish_bytes(n: int, nnz: int) -> int:
    """A publish sweep of ``n`` pages, ``nnz`` of them non-zero: the image
    read once; the compacted non-zero pages, the zero bitmap (a byte a page)
    and the 4-byte checksums written once."""
    return n * PAGE + nnz * PAGE + n + 4 * n


def share(nbytes: float, device_s: float):
    """Percent of the HBM roof, or None when the kernel did not run."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s


def matches(kernel: str, event_name: str) -> bool:
    return any(k in event_name for k in KERNEL_NAMES[kernel])
