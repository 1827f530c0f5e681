"""Distributed-optimization helpers: int8 gradient compression with error
feedback (the partition rules and the compressed all-reduce are ROADMAP
A12's)."""
from .collectives import ErrorFeedback, compress_tree, dequantize_int8, quantize_int8
