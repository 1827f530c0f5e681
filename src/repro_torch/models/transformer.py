"""Decoder-only LM assembly for the dense and MoE families: embedding, the
blocks, final norm, unembedding, and DeepSeek-V3's multi-token prediction.

  dense : a stack of identical (attention + SwiGLU) blocks
  moe   : ``n_dense_layers`` leading dense blocks (a *list*, as in the JAX
          package), then a stack of (attention + MoE) blocks whose aux losses
          add up; with ``cfg.mtp`` an extra depth-1 module (``mtp``)

Stacked layer weights lie on a leading axis as in the JAX package, and the
JAX ``lax.scan`` over them becomes a Python loop over that axis (eager
PyTorch).  Under autograd with ``cfg.remat`` each block runs inside
``torch.utils.checkpoint`` (the twin of the reference's ``jax.checkpoint``):
only its input is kept, and the backward runs its forward again.  Decode
caches are stacked the same way (dense: ``{"k", "v"}: (L, B, Hkv, max_len,
Dh)``; moe: ``{"scan": <stacked>, "dense": [<one a dense layer>]}``), and
each step writes its layer's slice in place.  The SSM, hybrid and VLM
families come later (ROADMAP A11) and raise here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.pagestore import resolve_device
from . import attention as attn_mod
from .common import cast_tree, embed, init_embedding, init_mlp, init_rmsnorm, mlp, rmsnorm, unembed
from .moe import init_moe, moe_ffn

Key = Union[int, torch.Generator]
PORTED_FAMILIES = ("dense", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: only "
                                  f"{', '.join(PORTED_FAMILIES)} are (the others are ROADMAP A11)")


def _generator(key: Key, device="cuda") -> torch.Generator:
    """The port's stand-in for a ``jax.random`` key: a ``torch.Generator`` on
    ``device`` seeded with ``key``, or ``key`` itself when it is one."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(key))
    return gen


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _norm(gen: torch.Generator, cfg: ModelConfig, dtype, layers: Tuple[int, ...]) -> Dict:
    return {"scale": torch.ones((*layers, cfg.d_model), dtype=dtype, device=gen.device)}


def init_dense_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                     layers: Tuple[int, ...] = ()) -> Dict:
    """One block's weights, or ``layers`` = (L,) stacked blocks' at once."""
    return {
        "ln1": _norm(gen, cfg, dtype, layers),
        "attn": attn_mod.init_attention(gen, cfg, dtype, layers),
        "ln2": _norm(gen, cfg, dtype, layers),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, layers),
    }


def dense_block(params, x, cfg: ModelConfig, positions=None, mrope_pos=None):
    x = x + attn_mod.attention(params["attn"], rmsnorm(params["ln1"], x), cfg,
                               positions, mrope_pos)
    return x + mlp(params["mlp"], rmsnorm(params["ln2"], x))


def dense_block_decode(params, x, cache, pos: int, cfg: ModelConfig, mrope_pos3=None):
    h, cache = attn_mod.decode(params["attn"], rmsnorm(params["ln1"], x), cache, pos, cfg,
                               mrope_pos3=mrope_pos3)
    x = x + h
    return x + mlp(params["mlp"], rmsnorm(params["ln2"], x)), cache


def init_moe_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                   layers: Tuple[int, ...] = ()) -> Dict:
    return {
        "ln1": _norm(gen, cfg, dtype, layers),
        "attn": attn_mod.init_attention(gen, cfg, dtype, layers),
        "ln2": _norm(gen, cfg, dtype, layers),
        "moe": init_moe(gen, cfg, dtype, layers),
    }


def moe_block(params, x, cfg: ModelConfig, positions=None):
    """-> (x, the block's aux loss)."""
    x = x + attn_mod.attention(params["attn"], rmsnorm(params["ln1"], x), cfg, positions)
    y, aux = moe_ffn(params["moe"], rmsnorm(params["ln2"], x), cfg)
    return x + y, aux


def moe_block_decode(params, x, cache, pos: int, cfg: ModelConfig):
    """One token; the MoE groups are the batch (``group_size`` = B), as in
    the JAX package, so the decode capacity is the batch's."""
    h, cache = attn_mod.decode(params["attn"], rmsnorm(params["ln1"], x), cache, pos, cfg)
    x = x + h
    y, _ = moe_ffn(params["moe"], rmsnorm(params["ln2"], x), cfg, group_size=x.shape[0])
    return x + y, cache


# --------------------------------------------------------------------------
# LM assembly
# --------------------------------------------------------------------------

def init_lm(key: Key, cfg: ModelConfig, device="cuda") -> Dict:
    """Parameters in ``cfg.param_dtype`` on ``device`` (a generator's own
    device when ``key`` is one)."""
    _check_family(cfg)
    gen = _generator(key, device)
    dtype = cfg.pdtype()
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dtype, cfg.tie_embeddings,
                                padded_vocab=cfg.padded_vocab),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, gen.device),
    }
    if cfg.family == "dense":
        params["layers"] = init_dense_block(gen, cfg, dtype, layers=(cfg.n_layers,))
        return params
    if cfg.n_dense_layers:
        params["dense_layers"] = [init_dense_block(gen, cfg, dtype)
                                  for _ in range(cfg.n_dense_layers)]
    params["layers"] = init_moe_block(gen, cfg, dtype, layers=(cfg.n_layers - cfg.n_dense_layers,))
    if cfg.mtp:
        proj = torch.randn((2 * cfg.d_model, cfg.d_model), generator=gen, device=gen.device)
        params["mtp"] = {
            "norm_h": init_rmsnorm(cfg.d_model, dtype, gen.device),
            "norm_e": init_rmsnorm(cfg.d_model, dtype, gen.device),
            "proj": (proj * 0.02).to(dtype),
            "block": init_dense_block(gen, cfg, dtype),
        }
    return params


def _n_stacked(layers: Dict) -> int:
    return layers["ln1"]["scale"].shape[0]


def _lm_trunk(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
              vision_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (pre-final-norm hidden states (B, S, D), aux): the
    MoE blocks' aux losses added in layer order, 0 for the dense family."""
    _check_family(cfg)
    cdt = cfg.cdtype()
    s = tokens.shape[1]
    cparams = cast_tree(params, cdt)
    x = embed(cparams["embed"], tokens, cdt)
    positions = torch.arange(s, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(block, p, h):
        if remat:
            return checkpoint(block, p, h, cfg, positions, use_reentrant=False)
        return block(p, h, cfg, positions)

    for p in cparams.get("dense_layers", []):
        x = run(dense_block, p, x)
    layers = cparams["layers"]
    for i in range(_n_stacked(layers)):
        if cfg.family == "moe":
            x, da = run(moe_block, _layer(layers, i), x)
            aux = aux + da
        else:
            x = run(dense_block, _layer(layers, i), x)
    return x, aux


def lm_forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
               vision_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, padded_vocab) float32, aux scalar).

    The JAX package casts the parameters to the compute dtype inside every
    call (``cast_tree``); so does this, once, and hands the cast tree to the
    trunk, whose own cast then copies nothing.  A tree already in the compute
    dtype (``ServerInstance`` keeps one) is used as it is."""
    cparams = cast_tree(params, cfg.cdtype())
    h, aux = _lm_trunk(cparams, tokens, cfg, vision_embeds)
    h = rmsnorm(cparams["final_norm"], h)
    return unembed(cparams["embed"], h, cfg.logits_fp32, vocab=cfg.vocab), aux


def lm_forward_mtp(params: Dict, tokens: torch.Tensor, cfg: ModelConfig):
    """DeepSeek-V3 multi-token prediction: an extra depth-1 module predicts
    token t+2 from [h_t ; emb(token_{t+1})].  -> (logits, mtp_logits or None
    without ``cfg.mtp``, aux)."""
    cdt = cfg.cdtype()
    cparams = cast_tree(params, cdt)
    h_trunk, aux = _lm_trunk(cparams, tokens, cfg)
    hn = rmsnorm(cparams["final_norm"], h_trunk)
    logits = unembed(cparams["embed"], hn, cfg.logits_fp32, vocab=cfg.vocab)
    if not cfg.mtp:
        return logits, None, aux
    x = embed(cparams["embed"], tokens, cdt)
    nxt = torch.cat([x[:, 1:], x[:, -1:]], dim=1)              # emb(token_{t+1})
    m = cparams["mtp"]
    comb = torch.cat([rmsnorm(m["norm_h"], h_trunk), rmsnorm(m["norm_e"], nxt)], dim=-1)
    h = dense_block(m["block"], comb @ m["proj"], cfg,
                    torch.arange(tokens.shape[1], device=tokens.device))
    mtp_logits = unembed(cparams["embed"], rmsnorm(cparams["final_norm"], h),
                         cfg.logits_fp32, vocab=cfg.vocab)
    return logits, mtp_logits, aux


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_lm_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> Dict[str, Any]:
    _check_family(cfg)
    cdt, dev = cfg.cdtype(), resolve_device(device)
    if cfg.family == "dense":
        return attn_mod.init_cache(cfg, batch, max_len, cdt, dev, layers=(cfg.n_layers,))
    caches = {"scan": attn_mod.init_cache(cfg, batch, max_len, cdt, dev,
                                          layers=(cfg.n_layers - cfg.n_dense_layers,))}
    if cfg.n_dense_layers:
        caches["dense"] = [attn_mod.init_cache(cfg, batch, max_len, cdt, dev)
                           for _ in range(cfg.n_dense_layers)]
    return caches


def lm_decode_step(params: Dict, tokens: torch.Tensor, caches, pos: int, cfg: ModelConfig):
    """tokens: (B, 1) new token ids at index ``pos`` -> (logits (B, 1, V),
    caches).  The caches are updated in place and returned."""
    _check_family(cfg)
    pos = int(pos)
    cdt = cfg.cdtype()
    cparams = cast_tree(params, cdt)
    x = embed(cparams["embed"], tokens, cdt)
    layers = cparams["layers"]
    if cfg.family == "dense":
        for i in range(_n_stacked(layers)):
            x, _ = dense_block_decode(_layer(layers, i), x, _layer(caches, i), pos, cfg)
    else:
        for p, c in zip(cparams.get("dense_layers", []), caches.get("dense", [])):
            x, _ = dense_block_decode(p, x, c, pos, cfg)
        for i in range(_n_stacked(layers)):
            x, _ = moe_block_decode(_layer(layers, i), x, _layer(caches["scan"], i), pos, cfg)
    x = rmsnorm(cparams["final_norm"], x)
    return unembed(cparams["embed"], x, cfg.logits_fp32, vocab=cfg.vocab), caches
