"""Train step builder: loss (cross-entropy + z-loss + MoE aux + optional
MTP), gradients, AdamW — the twin of the JAX package's ``train/trainstep.py``.

The step is a function of ``(state, batch) -> (state, metrics)``, as in the
reference; ``torch.autograd`` takes the place of ``jax.value_and_grad``.  The
logits are pinned vocab-parallel (``constrain``, the identity without an
active mesh), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models import transformer as tf_mod
from ..models.model_zoo import Model
from ..sharding.partition import active_mesh, constrain, constrain_like
from ..tree import tree_map
from .optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw


class TrainState(NamedTuple):
    """Everything a train step carries forward (params + optimizer)."""

    params: Any
    opt: AdamWState


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Auxiliary-loss weights layered onto the cross-entropy objective."""

    z_loss: float = 1e-4
    aux_weight: float = 0.01     # MoE load-balance loss
    mtp_weight: float = 0.3      # DeepSeek-V3 MTP objective weight


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE in float32 with optional z-loss; logits (B, S, V).

    Under an active mesh the log-sum-exp and the label logit are taken as
    the reference takes them (a max-shifted sum, a one-hot contraction):
    with vocab-parallel logits (V sharded over 'model') every operand stays
    sharded and partial sums are reduced, instead of all-gathering the
    (B, S, V) logits.  On one card ``torch.logsumexp`` and a ``gather`` give
    the same values and save a second (B, S, V) float32 tensor (3.3 GB at
    Phi-4-mini's vocabulary and 4,096 tokens).
    """
    logits = constrain(logits, ("pod", "data"), None, "model").to(torch.float32)
    if active_mesh() is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    else:
        # the reference's forms, which keep vocab-parallel logits sharded:
        # jax.nn.logsumexp's shift by the (gradient-free) max, and the
        # one-hot contraction, its (B, V) vocab ids laid out as the logits
        # (a zeros_like of their first position) so it is built shard by shard
        mx = logits.amax(dim=-1).detach()
        lse = torch.log(torch.exp(logits - mx.unsqueeze(-1)).sum(dim=-1)) + mx
        vocab = (torch.arange(logits.shape[-1], device=logits.device)
                 + torch.zeros_like(logits[:, 0], dtype=torch.long))
        onehot = (labels.long().unsqueeze(-1) == vocab.unsqueeze(1)).to(torch.float32)
        ll = torch.einsum("bsv,bsv->bs", logits, onehot)
        lse = constrain(lse, ("pod", "data"), None)
        ll = constrain(ll, ("pod", "data"), None)
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * (lse ** 2).mean()
    return loss


def make_loss_fn(model: Model, loss_cfg: LossConfig = LossConfig()) -> Callable:
    cfg = model.cfg

    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict]:
        labels = batch["labels"]
        if cfg.family == "moe" and cfg.mtp:
            logits, mtp_logits, aux = tf_mod.lm_forward_mtp(params, batch["tokens"], cfg)
            # shift-1 main objective
            loss = cross_entropy(logits[:, :-1], labels[:, 1:], loss_cfg.z_loss)
            # MTP predicts t+2
            mtp = cross_entropy(mtp_logits[:, :-2], labels[:, 2:], 0.0)
            loss = loss + loss_cfg.mtp_weight * mtp + loss_cfg.aux_weight * aux
            return loss, {"aux": aux, "mtp": mtp}
        logits, aux = model.forward(params, batch)
        loss = cross_entropy(logits[:, :-1], labels[:, 1:], loss_cfg.z_loss)
        if cfg.family == "moe":
            loss = loss + loss_cfg.aux_weight * aux
        return loss, {"aux": aux}

    return loss_fn


def make_train_step(model: Model, opt_cfg: AdamWConfig = AdamWConfig(),
                    loss_cfg: LossConfig = LossConfig(),
                    grad_transform: Optional[Callable] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); the parameters
    and moments of ``state`` are updated in place (``adamw_update``)."""
    loss_fn = make_loss_fn(model, loss_cfg)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        # leaves that share the parameters' storage and record the graph
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        with torch.enable_grad():
            loss, extra = loss_fn(leaves, batch)
            loss.backward()
        grads = tree_map(lambda t: constrain_like(t.grad, t) if t.grad is not None
                         else torch.zeros_like(t), leaves)
        del leaves
        new_params, new_opt, om = adamw_update(opt_cfg, grads, state.opt, state.params,
                                               grad_transform)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in extra.items()}, **om}
        return TrainState(new_params, new_opt), metrics

    return train_step


def init_train_state(model: Model, key) -> TrainState:
    params = model.init(key)
    return TrainState(params, init_adamw(params))
