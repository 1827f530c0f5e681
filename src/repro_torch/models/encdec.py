"""Encoder-decoder backbone (SeamlessM4T-style, audio family).

The audio frontend is a stub, as in the JAX package: the model consumes
precomputed frame embeddings (B, T_frames, d_model).  Encoder blocks use
bidirectional self-attention; decoder blocks use causal self-attention and
cross-attention over the encoder output, all through the flash-attention op
(on a CUDA tensor the hand-written kernels: the encoder and the cross
attention non-causal, the cross attention with Sq != Skv, and Sq = 1 at
decode).

Decode caches: ``{"self": <GQA caches stacked over decoder layers>, "cross":
(n_dec, 2, B, H, T, Dh)}``, the cross K/V computed once from the encoder
output (or zeros of ``enc_len`` frames without one, as the JAX package's
serving engine starts).  A decode step writes the self-attention caches in
place; the cross K/V stay as they are.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.pagestore import resolve_device
from ..sharding.partition import constrain
from . import attention as attn_mod
from .common import cast_tree, dense_init, embed, init_embedding, init_mlp, mlp, rmsnorm, unembed
from .transformer import Key, _generator, _layer, _n_stacked, _norm, _run


# -- cross attention -------------------------------------------------------

def init_cross_attn(gen: torch.Generator, cfg: ModelConfig, dtype,
                    layers: Tuple[int, ...] = ()) -> Dict:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (*layers, d, h * dh), dtype, fan_in=d),
        "wk": dense_init(gen, (*layers, d, h * dh), dtype, fan_in=d),
        "wv": dense_init(gen, (*layers, d, h * dh), dtype, fan_in=d),
        "wo": dense_init(gen, (*layers, h * dh, d), dtype, fan_in=h * dh),
    }


def cross_kv(params: Dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """enc_out (B, T, D) -> k, v (B, H, T, Dh): transposed views."""
    b, t, _ = enc_out.shape
    h, dh = cfg.n_heads, cfg.head_dim
    k = (enc_out @ params["wk"]).view(b, t, h, dh).transpose(1, 2)
    v = (enc_out @ params["wv"]).view(b, t, h, dh).transpose(1, 2)
    return k, v


def cross_attn(params: Dict, x: torch.Tensor, k, v, cfg: ModelConfig) -> torch.Tensor:
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    q = (x @ params["wq"]).view(b, s, h, dh).transpose(1, 2)
    o = attn_mod.attend(q, k, v, causal=False)
    return o.transpose(1, 2).reshape(b, s, h * dh) @ params["wo"]


# -- blocks -----------------------------------------------------------------

def init_enc_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                   layers: Tuple[int, ...] = ()) -> Dict:
    return {
        "ln1": _norm(gen, cfg, dtype, layers),
        "attn": attn_mod.init_gqa(gen, cfg, dtype, layers),
        "ln2": _norm(gen, cfg, dtype, layers),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, layers),
    }


def enc_block(params, x, cfg: ModelConfig):
    x = constrain(x, ("pod", "data"), None, None)
    x = x + attn_mod.gqa_attention(params["attn"], rmsnorm(params["ln1"], x), cfg, causal=False)
    x = x + mlp(params["mlp"], rmsnorm(params["ln2"], x))
    return constrain(x, ("pod", "data"), None, None)


def init_dec_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                   layers: Tuple[int, ...] = ()) -> Dict:
    return {
        "ln1": _norm(gen, cfg, dtype, layers),
        "self": attn_mod.init_gqa(gen, cfg, dtype, layers),
        "ln2": _norm(gen, cfg, dtype, layers),
        "cross": init_cross_attn(gen, cfg, dtype, layers),
        "ln3": _norm(gen, cfg, dtype, layers),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, layers),
    }


def dec_block(params, x, enc_out, cfg: ModelConfig):
    x = constrain(x, ("pod", "data"), None, None)
    x = x + attn_mod.gqa_attention(params["self"], rmsnorm(params["ln1"], x), cfg, causal=True)
    k, v = cross_kv(params["cross"], enc_out, cfg)
    x = x + cross_attn(params["cross"], rmsnorm(params["ln2"], x), k, v, cfg)
    x = x + mlp(params["mlp"], rmsnorm(params["ln3"], x))
    return constrain(x, ("pod", "data"), None, None)


# -- model ------------------------------------------------------------------

def init_encdec(key: Key, cfg: ModelConfig, device="cuda") -> Dict:
    """Parameters in ``cfg.param_dtype`` on ``device`` (a generator's own
    device when ``key`` is one)."""
    gen = _generator(key, device)
    dtype = cfg.pdtype()
    return {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dtype, cfg.tie_embeddings,
                                padded_vocab=cfg.padded_vocab),
        "enc_layers": init_enc_block(gen, cfg, dtype, layers=(cfg.n_enc_layers,)),
        "dec_layers": init_dec_block(gen, cfg, dtype, layers=(cfg.n_dec_layers,)),
        "enc_norm": _norm(gen, cfg, dtype, ()),
        "final_norm": _norm(gen, cfg, dtype, ()),
    }


def encode(params: Dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, T, D) stub frontend embeddings -> encoder output."""
    cparams = cast_tree(params, cfg.cdtype())
    x = frames.to(cfg.cdtype())
    layers = cparams["enc_layers"]
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(_n_stacked(layers)):
        x = _run(enc_block, remat, _layer(layers, i), x, cfg)
    return rmsnorm(cparams["enc_norm"], x)


def encdec_forward(params: Dict, frames: torch.Tensor, tokens: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (decoder logits (B, S, padded_vocab), aux = 0)."""
    cdt = cfg.cdtype()
    cparams = cast_tree(params, cdt)
    enc_out = encode(cparams, frames, cfg)
    x = embed(cparams["embed"], tokens, cdt)
    layers = cparams["dec_layers"]
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(_n_stacked(layers)):
        x = _run(dec_block, remat, _layer(layers, i), x, enc_out, cfg)
    x = rmsnorm(cparams["final_norm"], x)
    logits = unembed(cparams["embed"], x, cfg.logits_fp32, vocab=cfg.vocab)
    return logits, torch.zeros((), dtype=torch.float32, device=tokens.device)


def init_encdec_caches(params: Dict, cfg: ModelConfig, batch: int, max_len: int,
                       enc_out: Optional[torch.Tensor] = None, enc_len: int = 0,
                       device="cuda"):
    """Self-attention KV caches and the cross K/V (from ``enc_out`` if given,
    zeros of ``enc_len`` frames else)."""
    cdt, dev = cfg.cdtype(), resolve_device(device)
    self_kv = attn_mod.init_gqa_cache(cfg, batch, max_len, cdt, dev, layers=(cfg.n_dec_layers,))
    if enc_out is not None:
        cross = cast_tree(params, cdt)["dec_layers"]["cross"]
        ck = torch.stack([torch.stack(cross_kv(_layer(cross, i), enc_out, cfg))
                          for i in range(cfg.n_dec_layers)])     # (L, 2, B, H, T, Dh)
    else:
        ck = torch.zeros((cfg.n_dec_layers, 2, batch, cfg.n_heads, enc_len, cfg.head_dim),
                         dtype=cdt, device=dev)
    return {"cross": ck, "self": self_kv}


def encdec_decode_step(params: Dict, tokens: torch.Tensor, caches, pos: int, cfg: ModelConfig):
    """tokens (B, 1) at index ``pos`` -> (logits (B, 1, V), caches); the
    self-attention caches written in place."""
    pos = int(pos)
    cdt = cfg.cdtype()
    cparams = cast_tree(params, cdt)
    x = embed(cparams["embed"], tokens, cdt)
    layers = cparams["dec_layers"]
    for i in range(_n_stacked(layers)):
        p = _layer(layers, i)
        h, _ = attn_mod.gqa_decode(p["self"], rmsnorm(p["ln1"], x), _layer(caches["self"], i),
                                   pos, cfg)
        x = x + h
        k, v = caches["cross"][i]
        x = x + cross_attn(p["cross"], rmsnorm(p["ln2"], x), k, v, cfg)
        x = x + mlp(p["mlp"], rmsnorm(p["ln3"], x))
    x = rmsnorm(cparams["final_norm"], x)
    return unembed(cparams["embed"], x, cfg.logits_fp32, vocab=cfg.vocab), caches
