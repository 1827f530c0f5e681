"""Uniform model interface over the ported architecture families.

``build(cfg, device="cuda")`` returns a ``Model`` with:
  init(key) -> params                               # key: int seed or torch.Generator
  forward(params, batch) -> (logits, aux)           # train/prefill
  init_caches(params, batch, max_len) -> caches     # decode state
  decode_step(params, batch, caches) -> (logits, caches)
  input_specs(shape) -> {name: TensorSpec}          # shapes and dtypes, no data
  make_batch(rng, shape) -> concrete small batch    # numpy rng, tensors on the device

Every family of the JAX package: the decoder-only ones (``forward``'s aux is
the MoE blocks' summed load-balancing loss, 0 for the others; the VLM's batch
may carry ``vision_embeds``) and the encoder-decoder one (its batch carries
``frames``, one stub embedding a position; ``init_caches`` takes the encoder
output as ``enc_out``, and without it starts from zero cross K/V).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from ..core.pagestore import resolve_device
from . import encdec as encdec_mod
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


def _frames_len(seq_len: int) -> int:
    return seq_len  # stub frontend: one embedding per "frame" position


def _build_encdec(cfg: ModelConfig, dev: torch.device) -> Model:
    cdt = cfg.cdtype()

    def init(key):
        return encdec_mod.init_encdec(key, cfg, device=dev)

    def forward(params, batch):
        return encdec_mod.encdec_forward(params, batch["frames"], batch["tokens"], cfg)

    def init_caches(params, batch_size, max_len, enc_out=None):
        return encdec_mod.init_encdec_caches(params, cfg, batch_size, max_len, enc_out=enc_out,
                                             enc_len=_frames_len(max_len), device=dev)

    def decode_step(params, batch, caches):
        return encdec_mod.encdec_decode_step(params, batch["tokens"], caches, batch["pos"], cfg)

    def input_specs(shape: ShapeSpec) -> Dict[str, Any]:
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": TensorSpec((b, 1), torch.int32), "pos": TensorSpec((), torch.int32)}
        specs = {"frames": TensorSpec((b, _frames_len(s), cfg.d_model), cdt),
                 "tokens": TensorSpec((b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = TensorSpec((b, s), torch.int32)
        return specs

    def make_batch(rng: np.random.Generator, shape: ShapeSpec):
        b, s = shape.global_batch, shape.seq_len

        def ints(size):
            return torch.from_numpy(rng.integers(0, cfg.vocab, size).astype(np.int32)).to(dev)

        out = {"tokens": ints((b, max(1, s) if shape.kind != "decode" else 1))}
        if shape.kind != "decode":
            out["frames"] = torch.from_numpy(
                rng.standard_normal((b, _frames_len(s), cfg.d_model))).to(dev, cdt)
        if shape.kind == "train":
            out["labels"] = ints((b, s))
        if shape.kind == "decode":
            out["pos"] = s // 2
        return out

    return Model(cfg, init, forward, init_caches, decode_step, input_specs, make_batch, dev)


def build(cfg: ModelConfig, device="cuda") -> Model:
    dev = resolve_device(device)
    if cfg.is_encdec:
        return _build_encdec(cfg, dev)
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
