"""Row gather: hand-written CUDA kernel and its plain torch version."""
from .ops import page_gather
from .ref import page_gather_ref
