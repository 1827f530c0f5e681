"""The four assigned input shapes (per-arch cells = arch × shape)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One named workload shape (sequence/batch geometry + kind)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason). long_500k needs sub-quadratic sequence mixing."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "SKIP(full-attn): 512k-token decode needs sub-quadratic mixing"
    return True, ""


def all_cells():
    from .base import all_arch_names, get_config

    for arch in all_arch_names():
        cfg = get_config(arch)
        for shape in SHAPES.values():
            yield cfg, shape
