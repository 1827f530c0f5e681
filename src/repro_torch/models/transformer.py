"""Decoder-only LM assembly for the dense family: embedding, a stack of
identical (attention + SwiGLU) blocks, final norm, unembedding.

Layer weights are stacked on a leading axis as in the JAX package, and the
JAX ``lax.scan`` over them becomes a Python loop over that axis (eager
PyTorch; ``remat`` has nothing to do without autograd).  Decode caches are
stacked the same way, ``{"k", "v"}: (L, B, Hkv, max_len, Dh)``, and each
step writes its layer's slice in place.  The MoE, SSM, hybrid and VLM
families come later (ROADMAP A11) and raise here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from ..core.pagestore import resolve_device
from . import attention as attn_mod
from .common import cast_tree, embed, init_embedding, init_mlp, init_rmsnorm, mlp, rmsnorm, unembed

Key = Union[int, torch.Generator]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: only the dense "
                                  "family is (the others are ROADMAP A11)")


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

def init_dense_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                     layers: Tuple[int, ...] = ()) -> Dict:
    """One block's weights, or ``layers`` = (L,) stacked blocks' at once."""
    def norm():
        return {"scale": torch.ones((*layers, cfg.d_model), dtype=dtype, device=gen.device)}

    return {
        "ln1": norm(),
        "attn": attn_mod.init_attention(gen, cfg, dtype, layers),
        "ln2": norm(),
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


# --------------------------------------------------------------------------
# LM assembly
# --------------------------------------------------------------------------

def init_lm(key: Key, cfg: ModelConfig, device="cuda") -> Dict:
    """Parameters in ``cfg.param_dtype`` on ``device`` (a generator's own
    device when ``key`` is one)."""
    _dense_only(cfg)
    gen = _generator(key, device)
    dtype = cfg.pdtype()
    return {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dtype, cfg.tie_embeddings,
                                padded_vocab=cfg.padded_vocab),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "layers": init_dense_block(gen, cfg, dtype, layers=(cfg.n_layers,)),
    }


def _lm_trunk(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
              vision_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (pre-final-norm hidden states (B, S, D), aux)."""
    _dense_only(cfg)
    cdt = cfg.cdtype()
    s = tokens.shape[1]
    cparams = cast_tree(params, cdt)
    x = embed(cparams["embed"], tokens, cdt)
    positions = torch.arange(s, device=tokens.device)
    layers = cparams["layers"]
    for i in range(layers["ln1"]["scale"].shape[0]):
        x = dense_block(_layer(layers, i), x, cfg, positions)
    return x, torch.zeros((), dtype=torch.float32, device=tokens.device)


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


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_lm_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> Dict[str, Any]:
    _dense_only(cfg)
    return attn_mod.init_cache(cfg, batch, max_len, cfg.cdtype(), resolve_device(device),
                               layers=(cfg.n_layers,))


def lm_decode_step(params: Dict, tokens: torch.Tensor, caches, pos: int, cfg: ModelConfig):
    """tokens: (B, 1) new token ids at index ``pos`` -> (logits (B, 1, V),
    caches).  The caches are updated in place and returned."""
    _dense_only(cfg)
    pos = int(pos)
    cdt = cfg.cdtype()
    cparams = cast_tree(params, cdt)
    x = embed(cparams["embed"], tokens, cdt)
    layers = cparams["layers"]
    for i in range(layers["ln1"]["scale"].shape[0]):
        x, _ = dense_block_decode(_layer(layers, i), x, _layer(caches, i), pos, cfg)
    x = rmsnorm(cparams["final_norm"], x)
    return unembed(cparams["embed"], x, cfg.logits_fp32, vocab=cfg.vocab), caches
