"""Row scatter, in place: hand-written CUDA kernel and its plain torch version."""
from .ops import page_scatter
from .ref import page_scatter_ref
