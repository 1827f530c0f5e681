"""Per-page poly32 checksum: hand-written CUDA kernel, plain torch version, weights."""
from .ops import page_checksum
from .ref import page_checksum_ref, poly_weights
