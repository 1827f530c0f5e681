"""Mixture-of-Experts FFN: shared experts + routed top-k, the GShard-style
capacity-factor dispatch/combine ("dropping") baseline and the sorted
dropless variant, as in the JAX package.

The router runs in float32 and returns a Switch-style load-balancing loss
for the train step.  ``moe_ffn`` is the default: tokens in groups of
``group_size``, each expert taking at most ``capacity`` tokens of a group
(overflow tokens drop to the residual path), dispatch and combine as
(group, token, expert, slot) one-hot einsums.  ``moe_ffn_sorted``
(``cfg.moe_impl == "sorted"``) sorts the (token, choice) pairs by expert and
runs each expert's group through its weights: no drops.  The JAX package's
``jax.lax.ragged_dot`` becomes a product per expert over its sorted group
(the group sizes are read on the host), and its ``.at[].add`` an
``index_add``.

Numerics reproduced on purpose:

* the float32 router is cast with the whole tree to the compute dtype
  (``cast_tree``) before the float32 product, so under bf16 compute its
  values are bf16-rounded and then upcast;
* ``disp`` and ``comb`` are built in float32 and cast to ``x``'s dtype;
* decode calls ``moe_ffn`` with ``group_size`` = the batch, so the capacity
  there is ``max(1, int(B * top_k / E * capacity_factor))`` and tokens drop
  by design (OLMoE at B = 4: 1 slot an expert).

Top-k order: the k largest probabilities in descending order, equal ones
lower expert index first, as ``jax.lax.top_k`` gives them (``torch.topk``
orders ties otherwise, so ``_top_k`` takes the head of a stable descending
sort).  The dispatched tokens are pinned expert-parallel (``constrain``,
the identity without an active mesh), as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding.partition import constrain, local_shards, pin_grad
from .common import dense_init, init_mlp, mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, layers: Tuple[int, ...] = ()) -> Dict:
    """The router is float32 whatever ``dtype`` is.  The JAX package's
    ``dense_init`` takes the leading dim of ``wi`` and ``wg`` (E, D, F), the
    expert count, as their fan-in: so does this."""
    d, fe, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {
        "router": dense_init(gen, (*layers, d, e), torch.float32, fan_in=d),
        "wi": dense_init(gen, (*layers, e, d, fe), dtype, fan_in=e),
        "wg": dense_init(gen, (*layers, e, d, fe), dtype, fan_in=e),
        "wo": dense_init(gen, (*layers, e, fe, d), dtype, fan_in=fe),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, fe * cfg.n_shared_experts, dtype, layers)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, descending, ties
    lower index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params: Dict, x: torch.Tensor, k: int):
    """x (..., D) -> (probs, top-k weights renormalised, top-k expert ids),
    the router in float32 on its (possibly bf16-rounded) weights."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, k)
    return probs, topw / (topw.sum(-1, keepdim=True) + 1e-9), topi


def _swiglu_experts(xin, wi, wg, wo):
    h = torch.einsum("gecd,edf->gecf", xin, wi)
    gate = torch.einsum("gecd,edf->gecf", xin, wg)
    return torch.einsum("gecf,efd->gecd", F.silu(gate) * h, wo)


def _expert_ffn(params: Dict, xin: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert over its slots: xin (G, E, C, D) -> (G, E, C, D).
    The dispatched tokens live on their expert's shard (all-to-all at this
    boundary under a mesh), the groups on the DP axes; under a mesh each
    rank runs its experts on its local shards (``local_shards``)."""
    xin = constrain(xin, ("pod", "data"), "model", None, None)
    xout = local_shards(_swiglu_experts, (xin,), heads=True,
                        by_head=(params["wi"], params["wg"], params["wo"]))
    return constrain(xout, ("pod", "data"), "model", None, None)


def moe_ffn_sorted(params: Dict, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dropless dispatch: (token, choice) pairs argsorted (stably)
    by expert id, each expert's group through its weights, the outputs
    added back into their tokens weighted by the renormalised top-k probs."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    probs, topw, topi = _route(params, xt, k)

    flat_e = topi.reshape(t * k)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    tok_sorted = flat_tok[order]
    w_sorted = topw.reshape(t * k)[order]
    xs = xt[tok_sorted]                                       # (t*k, d)
    sizes = torch.bincount(flat_e, minlength=e).tolist()

    parts, start = [], 0
    for i, n in enumerate(sizes):                             # ragged_dot, expert by expert
        if n:
            xi = xs[start:start + n]
            act = F.silu(xi @ params["wg"][i]) * (xi @ params["wi"][i])
            parts.append(act @ params["wo"][i])
        start += n
    out = torch.cat(parts) if parts else xs.new_zeros((0, d))
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device).index_add(
        0, tok_sorted, out * w_sorted[:, None].to(out.dtype))

    top1 = F.one_hot(topi[:, 0], e).float()
    aux = (top1.mean(dim=0) * probs.mean(dim=0)).sum() * e
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x)
    return y, aux.float()


def moe_ffn(params: Dict, x: torch.Tensor, cfg: ModelConfig,
            group_size: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).

    Tokens in groups of ``group_size``, per-group expert capacity
    C = max(1, int(group_size * top_k / E * capacity_factor)); a (token,
    choice) past its expert's C slots is dropped.  ``cfg.moe_impl ==
    "sorted"`` takes ``moe_ffn_sorted`` instead."""
    if cfg.moe_impl == "sorted":
        return moe_ffn_sorted(params, x, cfg)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = max(1, t // group_size)
    gs = t // g
    xt = pin_grad(x.reshape(g, gs, d))
    probs, topw, topi = _route(params, xt, k)                  # (g, s, e), (g, s, k)

    cap = max(1, int(gs * k / e * cfg.capacity_factor))
    onehot = F.one_hot(topi, e).float()                        # (g, s, k, e)
    per_tok = onehot.sum(2)                                    # (g, s, e)
    pos_in_e = torch.cumsum(per_tok, dim=1) - per_tok          # tokens ahead in the queue
    prior_within = torch.cumsum(onehot, dim=2) - onehot        # earlier choices of the token
    slot = (torch.einsum("gske,gse->gsk", onehot, pos_in_e)
            + torch.einsum("gske,gske->gsk", onehot, prior_within))
    keep = slot < cap
    w = topw * keep

    # one_hot of a slot >= cap is all zero, as jax.nn.one_hot gives it
    slot_oh = ((slot.to(torch.int32)[..., None] == torch.arange(cap, device=x.device))
               .float() * keep[..., None])                     # (g, s, k, c)
    disp = torch.einsum("gske,gskc->gsec", onehot, slot_oh).to(x.dtype)
    comb = torch.einsum("gske,gskc->gsec", onehot * w[..., None], slot_oh).to(x.dtype)

    xin = torch.einsum("gsec,gsd->gecd", disp, xt)             # (g, e, c, d)
    y = torch.einsum("gsec,gecd->gsd", comb, _expert_ffn(params, xin))

    frac = onehot[:, :, 0, :].mean(dim=1)                      # top-1 assignment share
    aux = (frac * probs.mean(dim=1)).sum(-1).mean() * e

    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x)
    return y, aux.float()
