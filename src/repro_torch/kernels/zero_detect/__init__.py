"""Zero-page detection: hand-written CUDA kernel and its plain torch version."""
from .ops import value_mask, zero_detect
from .ref import zero_detect_ref
