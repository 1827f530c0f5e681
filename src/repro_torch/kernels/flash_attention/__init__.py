"""Grouped-query flash attention: hand-written CUDA kernels (two forward
routes and a backward) and their plain torch versions."""
from .ops import CHUNKED_THRESHOLD, FlashAttentionFn, flash_attention, flash_attention_bwd
from .ref import attention_ref, chunked_attention_ref, flash_attention_bwd_ref
