"""Sharding rules and placements (``partition``), gradient compression with
error feedback and the compressed all-reduce (``collectives``)."""
from .collectives import (ErrorFeedback, compress_tree, compressed_psum, dequantize_int8,
                          quantize_int8)
