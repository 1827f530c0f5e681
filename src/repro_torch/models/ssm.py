"""Sequence-mixing state-space cells: Mamba2 (SSD) and xLSTM (sLSTM/mLSTM).

All three support two modes, as in the JAX package:
  * full-sequence (training / prefill) -- Mamba2's chunked formulation
    (quadratic within a chunk, linear state passing across chunks, the
    reference's ``lax.scan`` over chunks a Python loop here), mLSTM's
    stabilised parallel form, and the sLSTM's scan, a Python loop over time;
  * single-step decode -- constant-size recurrent state per layer.  The
    decode functions write the new state into the given state's tensors in
    place (the JAX package returns an updated copy) and return it, as the
    attention decode writes its cache.

Initialisers take a ``torch.Generator`` and ``layers`` = (L,) or (G, K) to
make stacked weights at once; the float32 leaves of the reference (``A_log``,
``D``, ``dt_bias``, ``wif``, ``fb``, ``wr``) stay float32 under any param
dtype, and ``cast_tree`` casts them to the compute dtype as it casts the
others.  Products in float32 take float32 operands (the JAX package promotes
a bf16 operand of a float32 einsum; ``torch.einsum`` does not).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding.partition import constrain, constrain_split, local_shards, pin_grad
from .common import dense_init, init_rmsnorm, rmsnorm

NEG_INIT = -1e30     # the stabiliser state's start


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum' producing lower-triangular cumulative sums:
    out[..., i, j] = sum_{j < k <= i} x[..., k]  (-inf above the diagonal)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -math.inf)


# ==========================================================================
# Mamba2 / SSD
# ==========================================================================

def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype,
                layers: Tuple[int, ...] = ()) -> Dict:
    d = cfg.d_model
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = h * p
    dev = gen.device
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev))
    return {
        "in_proj": dense_init(gen, (*layers, d, 2 * d_in + 2 * n + h), dtype, fan_in=d),
        "conv_w": dense_init(gen, (*layers, 4, d_in + 2 * n), dtype, fan_in=4),
        "A_log": a_log.expand(*layers, h).clone(),
        "D": torch.ones((*layers, h), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((*layers, h), dtype=torch.float32, device=dev),
        "norm": init_rmsnorm(d_in, dtype, dev, layers),
        "out_proj": dense_init(gen, (*layers, d_in, d), dtype, fan_in=d_in),
    }


def _mamba2_inputs(params, x: torch.Tensor, cfg: ModelConfig):
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = h * p
    L = x.shape[1]
    z, xbc, dt = torch.tensor_split(x @ params["in_proj"], [d_in, 2 * d_in + 2 * n], dim=-1)
    # causal depthwise conv (width 4) over x, B, C
    w = params["conv_w"]
    xbc_pad = F.pad(xbc, (0, 0, 3, 0))
    conv = 0
    for i in range(4):
        conv = conv + xbc_pad[:, i:i + L] * w[i]
    xs, B, C = torch.tensor_split(F.silu(conv), [d_in, d_in + n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    return z, xs, B, C, dt, A


def mamba2_ssd(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence chunked SSD. x: (B, L, D); L % chunk == 0.  The
    reference's three-operand einsums are taken pairwise so that no
    intermediate is larger than (b, c, h, q, q) or (b, c, q, h, p)."""
    bsz, L, _ = x.shape
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = min(cfg.ssm_chunk, L)
    assert L % q == 0
    nc = L // q
    z, xs, B, C, dt, A = _mamba2_inputs(params, x, cfg)
    xh = xs.reshape(bsz, nc, q, h, p).float()
    Bh = B.reshape(bsz, nc, q, n).float()
    Ch = C.reshape(bsz, nc, q, n).float()
    dth = dt.reshape(bsz, nc, q, h)
    dA = dth * A                                           # (b, c, q, h)

    # within-chunk (diagonal) term; dt folds into the input side (x_k * dt_k)
    xdt = xh * dth[..., None]                              # (b, c, q, h, p)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))      # (b, c, h, q, q)
    scores = torch.einsum("bcqn,bckn->bcqk", Ch, Bh)       # (b, c, q, k)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", Lmat * scores[:, :, None], xdt)

    # chunk-final states
    decay_out = torch.exp(dA.sum(dim=2, keepdim=True) - torch.cumsum(dA, dim=2))
    states = torch.einsum("bcqhp,bcqn->bchpn", xh * (dth * decay_out)[..., None], Bh)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA.sum(dim=2))                 # (b, c, h)
    carry = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (b, c, h, p, n)

    decay_in = torch.exp(torch.cumsum(dA, dim=2))          # (b, c, q, h)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Ch, prev_states) * decay_in[..., None]

    y = (y_diag + y_off).reshape(bsz, L, h, p)
    y = y + xh.reshape(bsz, L, h, p) * params["D"][:, None]
    y = pin_grad(y.reshape(bsz, L, h * p)).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return y @ params["out_proj"]


def init_mamba2_state(cfg: ModelConfig, batch: int, device,
                      layers: Tuple[int, ...] = ()) -> Dict:
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "conv": torch.zeros((*layers, batch, 4, h * p + 2 * n), dtype=torch.float32,
                            device=device),
        "ssm": torch.zeros((*layers, batch, h, p, n), dtype=torch.float32, device=device),
    }


def mamba2_decode(params: Dict, x: torch.Tensor, state: Dict,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step. x: (B, 1, D); ``state`` updated in place."""
    bsz = x.shape[0]
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = h * p
    z, xbc, dt = torch.tensor_split((x @ params["in_proj"])[:, 0],
                                    [d_in, 2 * d_in + 2 * n], dim=-1)
    conv_buf = torch.cat([state["conv"][:, 1:], xbc.float()[:, None]], dim=1)
    conv = F.silu((conv_buf * params["conv_w"].float()).sum(dim=1)).to(x.dtype)
    xs, B, C = torch.tensor_split(conv, [d_in, d_in + n], dim=-1)
    dt1 = F.softplus(dt.float() + params["dt_bias"])                   # (b, h)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt1 * A)                                            # (b, h)
    xhead = xs.reshape(bsz, h, p).float()
    ssm = state["ssm"] * dA[..., None, None] + (
        (dt1[..., None] * xhead)[..., None] * B.float()[:, None, None, :])
    # the new state in its cache's layout (batch over DP, ``cache_specs``)
    ssm = constrain(ssm, ("pod", "data"), None, None, None)
    y = torch.einsum("bn,bhpn->bhp", C.float(), ssm)
    y = y + xhead * params["D"][:, None]
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z[:, None]))
    state["ssm"].copy_(ssm)
    state["conv"].copy_(conv_buf)
    return y @ params["out_proj"], state


# ==========================================================================
# mLSTM (xLSTM matrix-memory cell) -- stabilised parallel / recurrent decode
# ==========================================================================

def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype,
               layers: Tuple[int, ...] = ()) -> Dict:
    d = cfg.d_model
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    dev = gen.device
    return {
        "wq": dense_init(gen, (*layers, d, h * dh), dtype, fan_in=d),
        "wk": dense_init(gen, (*layers, d, h * dh), dtype, fan_in=d),
        "wv": dense_init(gen, (*layers, d, h * dh), dtype, fan_in=d),
        "wif": dense_init(gen, (*layers, d, 2 * h), torch.float32, fan_in=d),
        "fb": torch.full((*layers, h), 3.0, dtype=torch.float32, device=dev),  # forget bias > 0
        "norm": init_rmsnorm(h * dh, dtype, dev, layers),
        "wo": dense_init(gen, (*layers, h * dh, d), dtype, fan_in=h * dh),
        "wog": dense_init(gen, (*layers, d, h * dh), dtype, fan_in=d),         # output gate
    }


def _mlstm_qkvif(params, x: torch.Tensor, cfg: ModelConfig):
    b, L, _ = x.shape
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    q = constrain_split(x @ params["wq"], h).reshape(b, L, h, dh)
    k = constrain_split(x @ params["wk"], h).reshape(b, L, h, dh)
    v = constrain_split(x @ params["wv"], h).reshape(b, L, h, dh)
    gif = x.float() @ params["wif"].float()
    i_pre, f_pre = gif.chunk(2, dim=-1)                    # (b, L, h)
    return q, k, v, i_pre, f_pre + params["fb"]


def mlstm_parallel(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Stabilised parallel mLSTM (training / prefill). x: (B, L, D).
    Materialises (B, L, L, H) float32 decay and score matrices, as the
    reference does."""
    b, L, _ = x.shape
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    q, k, v, i_pre, f_pre = _mlstm_qkvif(params, x, cfg)
    logf = F.logsigmoid(f_pre)                             # (b, L, h)

    qf = q.float() * dh ** -0.5
    kf, vf = k.float(), v.float()

    # decay matrix in log space: D[i, j] = sum_{j < t <= i} logf_t + i_pre_j
    lcs = torch.cumsum(logf, dim=1)                        # (b, L, h)
    Dlog = lcs[:, :, None, :] - lcs[:, None, :, :] + i_pre[:, None, :, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))[None, :, :, None]
    Dlog = Dlog.masked_fill(~mask, -math.inf)
    m = Dlog.amax(dim=2, keepdim=True)                     # row stabiliser
    Dmat = torch.exp(Dlog - m)                             # (b, L, L, h)
    sw = torch.einsum("blhd,bthd->blth", qf, kf) * Dmat    # (b, L, T, h)
    norm = torch.maximum(sw.sum(dim=2).abs(), torch.exp(-m[:, :, 0]))    # (b, L, h)
    yt = torch.einsum("blth,bthd->blhd", sw, vf) / (norm[..., None] + 1e-6)
    og = torch.sigmoid(x @ params["wog"])
    y = pin_grad(yt.reshape(b, L, h * dh)).to(x.dtype) * og.to(x.dtype)
    return rmsnorm(params["norm"], y) @ params["wo"]


def init_mlstm_state(cfg: ModelConfig, batch: int, device,
                     layers: Tuple[int, ...] = ()) -> Dict:
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "C": torch.zeros((*layers, batch, h, dh, dh), dtype=torch.float32, device=device),
        "m": torch.full((*layers, batch, h), NEG_INIT, dtype=torch.float32, device=device),
        "n": torch.zeros((*layers, batch, h, dh), dtype=torch.float32, device=device),
    }


def mlstm_decode(params: Dict, x: torch.Tensor, state: Dict,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One token; ``state`` updated in place."""
    b = x.shape[0]
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    q, k, v, i_pre, f_pre = _mlstm_qkvif(params, x, cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                    # (b, h, dh)
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]                # (b, h)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    fg = torch.exp(logf + state["m"] - m_new)
    ig = torch.exp(i_pre - m_new)
    kf, vf = k.float(), v.float()
    C = state["C"] * fg[..., None, None] + (ig[..., None] * kf)[..., None] * vf[..., None, :]
    n = state["n"] * fg[..., None] + ig[..., None] * kf
    qf = q.float() * dh ** -0.5
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(), torch.exp(-m_new))
    yt = num / (den[..., None] + 1e-6)
    og = torch.sigmoid(x @ params["wog"])[:, 0]
    y = yt.reshape(b, 1, h * dh).to(x.dtype) * og[:, None].to(x.dtype)
    out = rmsnorm(params["norm"], y) @ params["wo"]
    state["C"].copy_(C)
    state["n"].copy_(n)
    state["m"].copy_(m_new)
    return out, state


# ==========================================================================
# sLSTM (xLSTM scalar cell) -- sequential scan
# ==========================================================================

def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype,
               layers: Tuple[int, ...] = ()) -> Dict:
    d = cfg.d_model
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    dev = gen.device
    return {
        "wx": dense_init(gen, (*layers, d, 4 * h * dh), dtype, fan_in=d),        # i, f, z, o
        # block-diagonal recurrent weights; the reference's fan-in is shape[0] = h
        "wr": dense_init(gen, (*layers, h, dh, 4 * dh), torch.float32, fan_in=h),
        "fb": torch.full((*layers, h, dh), 3.0, dtype=torch.float32, device=dev),
        "norm": init_rmsnorm(h * dh, dtype, dev, layers),
        "wo": dense_init(gen, (*layers, h * dh, d), dtype, fan_in=h * dh),
    }


def _slstm_loop(xg: torch.Tensor, wr: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """The recurrence over xg (b, L, h, 4*dh), a step a token in a Python
    loop (the reference's ``lax.scan``) -> (b, L, h, dh)."""
    b, L, h, _ = xg.shape
    dh = fb.shape[-1]
    params = {"wr": wr, "fb": fb}
    zeros = torch.zeros((b, h, dh), dtype=torch.float32, device=xg.device)
    carry = (zeros, zeros, torch.full((b, h, dh), NEG_INIT, device=xg.device), zeros)
    ys = []
    for t in range(L):
        carry, y = _slstm_step(params, carry, xg[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1)


def _slstm_step(params, carry, xg: torch.Tensor):
    """xg: (b, h, 4*dh) float32 pre-activations from the input path; carry
    (c, n, m, h) -> (new carry, h)."""
    c, n, m, hprev = carry
    g = xg + torch.einsum("bhd,hde->bhe", hprev, params["wr"].float())
    i_pre, f_pre, z_pre, o_pre = g.chunk(4, dim=-1)
    f_pre = f_pre + params["fb"]
    m_new = torch.maximum(f_pre + m, i_pre)
    ig = torch.exp(i_pre - m_new)
    fg = torch.exp(f_pre + m - m_new)
    c_new = fg * c + ig * torch.tanh(z_pre)
    n_new = fg * n + ig
    hnew = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, m_new, hnew), hnew


def slstm_scan(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A step a token, in a Python loop (the reference's ``lax.scan``); under
    a mesh on each rank's batch shard (``local_shards``)."""
    b, L, _ = x.shape
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    xg = constrain_split((x @ params["wx"]).float(), h).reshape(b, L, h, 4 * dh)
    y = local_shards(_slstm_loop, (xg,), (params["wr"], params["fb"]))
    y = pin_grad(y.reshape(b, L, h * dh)).to(x.dtype)
    return rmsnorm(params["norm"], y) @ params["wo"]


def init_slstm_state(cfg: ModelConfig, batch: int, device,
                     layers: Tuple[int, ...] = ()) -> Dict:
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    shape = (*layers, batch, h, dh)
    return {"c": torch.zeros(shape, dtype=torch.float32, device=device),
            "h": torch.zeros(shape, dtype=torch.float32, device=device),
            "m": torch.full(shape, NEG_INIT, dtype=torch.float32, device=device),
            "n": torch.zeros(shape, dtype=torch.float32, device=device)}


def slstm_decode(params: Dict, x: torch.Tensor, state: Dict,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One token; ``state`` updated in place."""
    b = x.shape[0]
    h, dh = cfg.ssm_heads, cfg.ssm_head_dim
    xg = constrain_split((x @ params["wx"]).float(), h).reshape(b, h, 4 * dh)
    carry = (state["c"], state["n"], state["m"], state["h"])
    new, y = _slstm_step(params, carry, xg)
    for name, t in zip(("c", "n", "m", "h"), new):
        state[name].copy_(t)
    y = y.reshape(b, 1, h * dh).to(x.dtype)
    return rmsnorm(params["norm"], y) @ params["wo"], state
