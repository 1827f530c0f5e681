"""Serving engine: prefill + decode with KV caches, greedy sampling.

``ServerInstance`` is the MicroVM analogue: a model, its parameters and its
caches.  As in the JAX package, prefill fills the caches by running one
decode step per prompt token (so the engine's path is the einsum decode
attention, not the flash kernel), and returns the last position's logits.

The JAX package casts the parameters to the compute dtype inside every
jitted step.  Eager PyTorch would pay that cast (the whole parameter tree)
on every decode step, so an instance makes its compute-dtype copy once, at
construction, and hands it to every step; the numbers are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.common import cast_tree
from ..models.model_zoo import Model, build


@dataclasses.dataclass
class ServerInstance:
    """A live serving instance: model, params, and decode caches."""

    model: Model
    params: Any
    caches: Any
    max_len: int
    pos: int = 0

    def __post_init__(self):
        self.params = cast_tree(self.params, self.model.cfg.cdtype())   # once per instance

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.model.device)

    def prefill(self, tokens) -> torch.Tensor:
        """Feed prompt tokens (B, S); returns last-position logits (B, V)."""
        tokens = self._tokens(tokens)
        logits, self.caches = _prefill_scan(self.model, self.params, tokens, self.caches,
                                            self.pos)
        self.pos += tokens.shape[1]
        return logits

    def decode(self, tokens) -> torch.Tensor:
        """One step: tokens (B, 1) -> logits (B, V)."""
        logits, self.caches = _decode_step(self.model, self.params, self._tokens(tokens),
                                           self.caches, self.pos)
        self.pos += 1
        return logits[:, 0]

    def generate(self, prompt, n_tokens: int) -> np.ndarray:
        """Greedy: (B, n_tokens) int token ids, the first from the prompt's
        last logits."""
        logits = self.prefill(prompt)
        out = []
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        for _ in range(n_tokens):
            out.append(tok[:, 0].cpu().numpy())
            logits = self.decode(tok)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        return np.stack(out, axis=1)


def _decode_step(model: Model, params, tokens, caches, pos: int):
    return model.decode_step(params, {"tokens": tokens, "pos": pos}, caches)


def _prefill_scan(model: Model, params, tokens, caches, start_pos: int):
    """Sequentially decode the prompt to fill caches; returns final logits."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, caches = _decode_step(model, params, tokens[:, t:t + 1], caches, start_pos + t)
    return logits[:, 0], caches


def new_instance(cfg: ModelConfig, params, batch: int, max_len: int,
                 device="cuda") -> ServerInstance:
    model = build(cfg, device=device)
    caches = model.init_caches(params, batch, max_len)
    return ServerInstance(model, params, caches, max_len)
