"""AdamW + gradient clipping + LR schedules, from scratch (no torch.optim),
the twin of the JAX package's ``train/optimizer.py``.

Optimizer state mirrors the parameter tree (float32 moments) in an
``AdamWState`` NamedTuple, as in the reference, so a checkpoint names its
arrays as the reference's does (``opt/m/...``, ``opt/step``).

Unlike the reference, ``adamw_update`` updates the parameters and both
moments in place and returns the same tensors: at full width that saves
12 B a parameter at the step's peak.  The arithmetic is the reference's,
operation for operation, in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    """AdamW optimizer state (step counter plus moment trees)."""

    step: torch.Tensor         # int32 scalar
    m: Any                     # first moment (tree like params)
    v: Any                     # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW hyperparameters (learning rate, betas, weight decay)."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_adamw(params) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                      v=tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' float32 sums of squares.  The leaves'
    sums are added one after another in ``jax.tree`` order (sorted keys),
    which is how XLA adds the reference's stack of them; inside a leaf each
    framework sums in its own order."""
    total = None
    for x in tree_leaves(tree):
        part = torch.sum(torch.square(x.to(torch.float32)))
        total = part if total is None else total + part
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params,
                 grad_transform: Optional[Callable] = None):
    """-> (params, new_state, metrics), ``params`` and the moments updated in
    place.  Decoupled weight decay; decay is skipped for 1-D leaves (norm
    scales, biases, gate vectors)."""
    if grad_transform is not None:
        grads = grad_transform(grads)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    def upd(p, g, m, v):
        # one leaf at a time, so the clipped gradient and the temporaries
        # never exist for the whole tree at once
        g = (g * scale).to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() > 1:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)

    with torch.no_grad():
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                              tree_leaves(state.v)):
            upd(p, g, m, v)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.m, state.v), metrics
