"""Grouped-query flash attention: hand-written CUDA kernel and its plain
torch versions."""
from .ops import CHUNKED_THRESHOLD, flash_attention
from .ref import attention_ref, chunked_attention_ref
