"""Hand-written Hopper kernels of the port, each beside its plain torch version.

``snapshot_fuse`` holds the fused publish sweep and the fused
gather→verify→scatter restore; ``zero_detect``, ``page_checksum``,
``page_gather`` and ``page_scatter`` are the piecemeal kernels of the same
data plane (zero scan, dedup hash, compaction, install and store writes);
``flash_attention`` is the grouped-query attention of the models' forward.
All are CUDA C++ under ``<name>/csrc/``, compiled at first use by
:mod:`repro_torch.kernels.build`.
"""
from .flash_attention import flash_attention
from .page_checksum import page_checksum
from .page_gather import page_gather
from .page_scatter import page_scatter, page_scatter_rows
from .snapshot_fuse import (
    ChecksumMismatchError,
    FusedPublishResult,
    FusedScatter,
    fused_publish,
    fused_restore,
    fused_restore_rows,
    make_fused_publish_fn,
)
from .zero_detect import zero_detect
