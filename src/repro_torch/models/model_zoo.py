"""Uniform model interface over the ported architecture families.

``build(cfg, device="cuda")`` returns a ``Model`` with:
  init(key) -> params                               # key: int seed or torch.Generator
  forward(params, batch) -> (logits, aux)           # train/prefill
  init_caches(params, batch, max_len) -> caches     # decode state
  decode_step(params, batch, caches) -> (logits, caches)
  input_specs(shape) -> {name: TensorSpec}          # shapes and dtypes, no data
  make_batch(rng, shape) -> concrete small batch    # numpy rng, tensors on the device

Decoder-only dense configs are ported; encoder-decoder configs raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from ..core.pagestore import resolve_device
from . import transformer as tf_mod


class TensorSpec(NamedTuple):
    """Shape and dtype of one input (the port's ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass
class Model:
    """A built model: config plus its init/forward/cache constructors."""

    cfg: ModelConfig
    init: Callable
    forward: Callable
    init_caches: Callable
    decode_step: Callable
    input_specs: Callable
    make_batch: Callable
    device: torch.device


def build(cfg: ModelConfig, device="cuda") -> Model:
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder configs are not ported yet (ROADMAP A11)")
    dev = resolve_device(device)
    cdt = cfg.cdtype()

    def init(key):
        return tf_mod.init_lm(key, cfg, device=dev)

    def forward(params, batch):
        return tf_mod.lm_forward(params, batch["tokens"], cfg,
                                 vision_embeds=batch.get("vision_embeds"))

    def init_caches(params, batch_size, max_len, enc_out=None):
        del params, enc_out
        return tf_mod.init_lm_caches(cfg, batch_size, max_len, device=dev)

    def decode_step(params, batch, caches):
        return tf_mod.lm_decode_step(params, batch["tokens"], caches, batch["pos"], cfg)

    def input_specs(shape: ShapeSpec) -> Dict[str, Any]:
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": TensorSpec((b, 1), torch.int32), "pos": TensorSpec((), torch.int32)}
        specs = {"tokens": TensorSpec((b, s), torch.int32)}
        if cfg.family == "vlm":
            specs["vision_embeds"] = TensorSpec((b, cfg.vision_prefix, cfg.d_model), cdt)
        if shape.kind == "train":
            specs["labels"] = TensorSpec((b, s), torch.int32)
        return specs

    def make_batch(rng: np.random.Generator, shape: ShapeSpec):
        b, s = shape.global_batch, shape.seq_len

        def ints(size):
            return torch.from_numpy(rng.integers(0, cfg.vocab, size).astype(np.int32)).to(dev)

        if shape.kind == "decode":
            return {"tokens": ints((b, 1)), "pos": s // 2}
        out = {"tokens": ints((b, s))}
        if cfg.family == "vlm":
            out["vision_embeds"] = torch.from_numpy(
                rng.standard_normal((b, cfg.vision_prefix, cfg.d_model))).to(dev, cdt)
        if shape.kind == "train":
            out["labels"] = ints((b, s))
        return out

    return Model(cfg, init, forward, init_caches, decode_step, input_specs, make_batch, dev)
