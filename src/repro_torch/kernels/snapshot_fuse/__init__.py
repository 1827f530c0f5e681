"""Fused snapshot data plane: single-sweep publish, verified gather→scatter restore."""
from .ops import (
    ChecksumMismatchError,
    FusedPublishResult,
    FusedScatter,
    fused_publish,
    fused_restore,
    make_fused_publish_fn,
)
