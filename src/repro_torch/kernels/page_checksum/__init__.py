"""Per-page poly32 checksum: plain torch version and its weights."""
from .ref import page_checksum_ref, poly_weights
