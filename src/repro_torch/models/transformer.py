"""Decoder-only LM assembly for every decoder-only family: embedding, the
blocks, final norm, unembedding, and DeepSeek-V3's multi-token prediction.

  dense/vlm : a stack of identical (attention + SwiGLU) blocks; the VLM's
              ``vision_embeds`` replace the first ``vision_prefix`` token
              embeddings and its attention takes M-RoPE positions
  moe       : ``n_dense_layers`` leading dense blocks (a *list*, as in the JAX
              package), then a stack of (attention + MoE) blocks whose aux losses
              add up; with ``cfg.mtp`` an extra depth-1 module (``mtp``)
  ssm       : a stack of (mLSTM, sLSTM) block pairs (xLSTM)
  hybrid    : groups of [one shared attention block + ``attn_every`` Mamba2
              blocks] (Zamba2): ``layers`` is stacked twice, (groups,
              attn_every, ...), and ``shared_attn`` is one dense block whose
              weights every group reuses

Stacked layer weights lie on leading axes as in the JAX package, and the
JAX ``lax.scan`` over them becomes a Python loop over those axes (eager
PyTorch).  Under autograd with ``cfg.remat`` each block (an xLSTM pair, a
hybrid group) runs inside ``torch.utils.checkpoint`` (the twin of the
reference's ``jax.checkpoint``): only its input is kept, and the backward
runs its forward again.  Decode caches are stacked the same way (dense/vlm:
``{"k", "v"}: (L, B, Hkv, max_len, Dh)``; moe: ``{"scan": <stacked>,
"dense": [<one a dense layer>]}``; ssm: ``{"m": <mLSTM state>, "s": <sLSTM
state>}`` stacked over pairs; hybrid: ``{"attn": <one KV cache a group>,
"mamba": <Mamba2 states stacked (groups, attn_every)>}``), and each step
writes its layer's slice in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.pagestore import resolve_device
from ..sharding.partition import constrain
from ..tree import tree_leaves
from . import attention as attn_mod
from . import ssm as ssm_mod
from .common import (MetaGenerator, cast_tree, embed, init_embedding, init_mlp, init_rmsnorm,
                     mlp, mrope_positions, normal, rmsnorm, unembed)
from .moe import init_moe, moe_ffn

Key = Union[int, torch.Generator]


def _generator(key: Key, device="cuda") -> torch.Generator:
    """The port's stand-in for a ``jax.random`` key: a ``torch.Generator`` on
    ``device`` seeded with ``key``, or ``key`` itself when it is one; on
    ``meta`` a ``MetaGenerator``, which draws nothing."""
    if isinstance(key, torch.Generator):
        return key
    dev = resolve_device(device)
    if dev.type == "meta":
        return MetaGenerator()
    gen = torch.Generator(device=dev)
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
    return init_rmsnorm(cfg.d_model, dtype, gen.device, layers)


def _run(block, remat: bool, *args):
    """``block(*args)``, inside ``torch.utils.checkpoint`` under ``remat``."""
    if remat:
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def init_dense_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                     layers: Tuple[int, ...] = ()) -> Dict:
    """One block's weights, or ``layers`` = (L,) stacked blocks' at once."""
    return {
        "ln1": _norm(gen, cfg, dtype, layers),
        "attn": attn_mod.init_attention(gen, cfg, dtype, layers),
        "ln2": _norm(gen, cfg, dtype, layers),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, layers),
    }


def _res_constrain(x, cfg: ModelConfig):
    """Residual-stream sharding: baseline = batch over DP; seq_parallel adds
    Megatron-SP (sequence dim sharded over the TP axis between blocks).
    The identity without an active mesh (``sharding.partition``).  The
    blocks also pin the stream between their attention and feed-forward
    halves: XLA's partitioner reduces a row-parallel product there, where
    DTensor would carry the partial sum on and multiply it by gathered
    weights (each TP rank the whole feed-forward)."""
    if cfg.seq_parallel:
        return constrain(x, ("pod", "data"), "model", None)
    return constrain(x, ("pod", "data"), None, None)


def dense_block(params, x, cfg: ModelConfig, positions=None, mrope_pos=None):
    x = _res_constrain(x, cfg)
    x = _res_constrain(x + attn_mod.attention(params["attn"], rmsnorm(params["ln1"], x), cfg,
                                              positions, mrope_pos), cfg)
    return _res_constrain(x + mlp(params["mlp"], rmsnorm(params["ln2"], x)), cfg)


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
    x = _res_constrain(x, cfg)
    x = _res_constrain(x + attn_mod.attention(params["attn"], rmsnorm(params["ln1"], x), cfg,
                                              positions), cfg)
    y, aux = moe_ffn(params["moe"], rmsnorm(params["ln2"], x), cfg)
    return _res_constrain(x + y, cfg), aux


def moe_block_decode(params, x, cache, pos: int, cfg: ModelConfig):
    """One token; the MoE groups are the batch (``group_size`` = B), as in
    the JAX package, so the decode capacity is the batch's."""
    h, cache = attn_mod.decode(params["attn"], rmsnorm(params["ln1"], x), cache, pos, cfg)
    x = x + h
    y, _ = moe_ffn(params["moe"], rmsnorm(params["ln2"], x), cfg, group_size=x.shape[0])
    return x + y, cache


def init_xlstm_pair(gen: torch.Generator, cfg: ModelConfig, dtype,
                    layers: Tuple[int, ...] = ()) -> Dict:
    return {
        "ln_m": _norm(gen, cfg, dtype, layers),
        "mlstm": ssm_mod.init_mlstm(gen, cfg, dtype, layers),
        "ln_s": _norm(gen, cfg, dtype, layers),
        "slstm": ssm_mod.init_slstm(gen, cfg, dtype, layers),
    }


def xlstm_pair(params, x, cfg: ModelConfig):
    x = _res_constrain(x, cfg)
    x = x + ssm_mod.mlstm_parallel(params["mlstm"], rmsnorm(params["ln_m"], x), cfg)
    x = x + ssm_mod.slstm_scan(params["slstm"], rmsnorm(params["ln_s"], x), cfg)
    return _res_constrain(x, cfg)


def xlstm_pair_decode(params, x, state, cfg: ModelConfig):
    h, _ = ssm_mod.mlstm_decode(params["mlstm"], rmsnorm(params["ln_m"], x), state["m"], cfg)
    x = x + h
    h, _ = ssm_mod.slstm_decode(params["slstm"], rmsnorm(params["ln_s"], x), state["s"], cfg)
    return x + h, state


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                     layers: Tuple[int, ...] = ()) -> Dict:
    return {"ln": _norm(gen, cfg, dtype, layers),
            "mamba": ssm_mod.init_mamba2(gen, cfg, dtype, layers)}


def mamba_block(params, x, cfg: ModelConfig):
    x = _res_constrain(x, cfg)
    return _res_constrain(
        x + ssm_mod.mamba2_ssd(params["mamba"], rmsnorm(params["ln"], x), cfg), cfg)


def mamba_block_decode(params, x, state, cfg: ModelConfig):
    h, state = ssm_mod.mamba2_decode(params["mamba"], rmsnorm(params["ln"], x), state, cfg)
    return x + h, state


def hybrid_group(params, x, shared, cfg: ModelConfig, positions=None):
    """The shared attention block, then the group's ``attn_every`` Mamba2
    blocks (``params`` stacked (attn_every, ...))."""
    x = dense_block(shared, x, cfg, positions)
    for j in range(_n_stacked(params)):
        x = mamba_block(_layer(params, j), x, cfg)
    return x


# --------------------------------------------------------------------------
# LM assembly
# --------------------------------------------------------------------------

def init_lm(key: Key, cfg: ModelConfig, device="cuda") -> Dict:
    """Parameters in ``cfg.param_dtype`` on ``device`` (a generator's own
    device when ``key`` is one)."""
    gen = _generator(key, device)
    dtype = cfg.pdtype()
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dtype, cfg.tie_embeddings,
                                padded_vocab=cfg.padded_vocab),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, gen.device),
    }
    fam = cfg.family
    if fam in ("dense", "vlm"):
        params["layers"] = init_dense_block(gen, cfg, dtype, layers=(cfg.n_layers,))
    elif fam == "moe":
        if cfg.n_dense_layers:
            params["dense_layers"] = [init_dense_block(gen, cfg, dtype)
                                      for _ in range(cfg.n_dense_layers)]
        params["layers"] = init_moe_block(gen, cfg, dtype,
                                          layers=(cfg.n_layers - cfg.n_dense_layers,))
        if cfg.mtp:
            proj = normal(gen, (2 * cfg.d_model, cfg.d_model))
            params["mtp"] = {
                "norm_h": init_rmsnorm(cfg.d_model, dtype, gen.device),
                "norm_e": init_rmsnorm(cfg.d_model, dtype, gen.device),
                "proj": (proj * 0.02).to(dtype),
                "block": init_dense_block(gen, cfg, dtype),
            }
    elif fam == "ssm":
        assert cfg.n_layers % 2 == 0
        params["layers"] = init_xlstm_pair(gen, cfg, dtype, layers=(cfg.n_layers // 2,))
    elif fam == "hybrid":
        k = cfg.attn_every
        assert cfg.n_layers % k == 0
        params["layers"] = init_mamba_block(gen, cfg, dtype, layers=(cfg.n_layers // k, k))
        params["shared_attn"] = init_dense_block(gen, cfg, dtype)
    else:
        raise ValueError(f"init_lm does not handle family {fam}")
    return params


def _n_stacked(layers: Dict) -> int:
    return tree_leaves(layers)[0].shape[0]


def _lm_trunk(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
              vision_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (pre-final-norm hidden states (B, S, D), aux): the
    MoE blocks' aux losses added in layer order, 0 for the other families."""
    cdt = cfg.cdtype()
    s = tokens.shape[1]
    cparams = cast_tree(params, cdt)
    x = constrain(embed(cparams["embed"], tokens, cdt), ("pod", "data"), None, None)
    mrope_pos = None
    if cfg.family == "vlm":
        if vision_embeds is not None:
            vp = vision_embeds.shape[1]
            x = torch.cat([vision_embeds.to(cdt), x[:, vp:]], dim=1)
        mrope_pos = mrope_positions(s, cfg.vision_prefix, cfg.vision_grid, device=tokens.device)
    positions = torch.arange(s, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()

    fam = cfg.family
    layers = cparams["layers"]
    if fam in ("dense", "vlm"):
        for i in range(_n_stacked(layers)):
            x = _run(dense_block, remat, _layer(layers, i), x, cfg, positions, mrope_pos)
    elif fam == "moe":
        for p in cparams.get("dense_layers", []):
            x = _run(dense_block, remat, p, x, cfg, positions)
        for i in range(_n_stacked(layers)):
            x, da = _run(moe_block, remat, _layer(layers, i), x, cfg, positions)
            aux = aux + da
    elif fam == "ssm":
        for i in range(_n_stacked(layers)):
            x = _run(xlstm_pair, remat, _layer(layers, i), x, cfg)
    elif fam == "hybrid":
        for i in range(_n_stacked(layers)):
            x = _run(hybrid_group, remat, _layer(layers, i), x, cparams["shared_attn"], cfg,
                     positions)
    else:
        raise ValueError(fam)
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
    cdt, dev = cfg.cdtype(), resolve_device(device)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return attn_mod.init_cache(cfg, batch, max_len, cdt, dev, layers=(cfg.n_layers,))
    if fam == "moe":
        caches = {"scan": attn_mod.init_cache(cfg, batch, max_len, cdt, dev,
                                              layers=(cfg.n_layers - cfg.n_dense_layers,))}
        if cfg.n_dense_layers:
            caches["dense"] = [attn_mod.init_cache(cfg, batch, max_len, cdt, dev)
                               for _ in range(cfg.n_dense_layers)]
        return caches
    if fam == "ssm":
        pairs = (cfg.n_layers // 2,)
        return {"m": ssm_mod.init_mlstm_state(cfg, batch, dev, pairs),
                "s": ssm_mod.init_slstm_state(cfg, batch, dev, pairs)}
    if fam == "hybrid":
        ng = cfg.n_layers // cfg.attn_every
        return {"attn": attn_mod.init_cache(cfg, batch, max_len, cdt, dev, layers=(ng,)),
                "mamba": ssm_mod.init_mamba2_state(cfg, batch, dev, (ng, cfg.attn_every))}
    raise ValueError(fam)


def mrope_pos3(cfg: ModelConfig, pos: int, device) -> torch.Tensor:
    """M-RoPE ids (3, 1) of one position: the vision prefix's raster (t = 0,
    h, w); a text token's three components equal, offset past the grid's
    longer side (``mrope_positions``)."""
    gw, vp = cfg.vision_grid[1], cfg.vision_prefix
    if pos < vp:
        ids = (0, pos // gw, pos % gw)
    else:
        ids = (pos - vp + max(cfg.vision_grid),) * 3
    return torch.tensor(ids, dtype=torch.int32, device=device)[:, None]


def lm_decode_step(params: Dict, tokens: torch.Tensor, caches, pos: int, cfg: ModelConfig):
    """tokens: (B, 1) new token ids at index ``pos`` -> (logits (B, 1, V),
    caches).  The caches are updated in place and returned."""
    pos = int(pos)
    cdt = cfg.cdtype()
    cparams = cast_tree(params, cdt)
    x = embed(cparams["embed"], tokens, cdt)
    layers = cparams["layers"]
    fam = cfg.family
    if fam in ("dense", "vlm"):
        pos3 = mrope_pos3(cfg, pos, tokens.device) if fam == "vlm" else None
        for i in range(_n_stacked(layers)):
            x, _ = dense_block_decode(_layer(layers, i), x, _layer(caches, i), pos, cfg, pos3)
    elif fam == "moe":
        for p, c in zip(cparams.get("dense_layers", []), caches.get("dense", [])):
            x, _ = dense_block_decode(p, x, c, pos, cfg)
        for i in range(_n_stacked(layers)):
            x, _ = moe_block_decode(_layer(layers, i), x, _layer(caches["scan"], i), pos, cfg)
    elif fam == "ssm":
        for i in range(_n_stacked(layers)):
            x, _ = xlstm_pair_decode(_layer(layers, i), x, _layer(caches, i), cfg)
    elif fam == "hybrid":
        shared = cparams["shared_attn"]
        for i in range(_n_stacked(layers)):
            x, _ = dense_block_decode(shared, x, _layer(caches["attn"], i), pos, cfg)
            group, states = _layer(layers, i), _layer(caches["mamba"], i)
            for j in range(_n_stacked(group)):
                x, _ = mamba_block_decode(_layer(group, j), x, _layer(states, j), cfg)
    else:
        raise ValueError(fam)
    x = rmsnorm(cparams["final_norm"], x)
    return unembed(cparams["embed"], x, cfg.logits_fp32, vocab=cfg.vocab), caches
