"""Row scatter, in place: hand-written CUDA kernel and its plain torch version."""
from .ops import page_scatter, page_scatter_rows
from .ref import page_scatter_ref, page_scatter_rows_ref
