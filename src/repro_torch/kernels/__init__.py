"""Hand-written Hopper kernels of the port, each beside its plain torch version.

``snapshot_fuse`` holds the fused publish sweep and the fused
gather→verify→scatter restore (CUDA C++, ``csrc/``), ``page_checksum`` the
plain poly32 checksum they are held to.  The CUDA libraries are compiled at
first use by :mod:`repro_torch.kernels.build`.
"""
from .snapshot_fuse import (
    ChecksumMismatchError,
    FusedPublishResult,
    FusedScatter,
    fused_publish,
    fused_restore,
    make_fused_publish_fn,
)
