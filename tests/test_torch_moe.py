"""The port's MoE FFN and MLA attention against the JAX package, on the
reduced ``olmoe-1b-7b`` and ``deepseek-v3-671b`` configs (the latter with a
shared expert and MLA), inputs and parameters from numpy seeds, the JAX
parameters carried across by ``params_from_numpy``.

Tolerances: float32, relative max error 1e-5 on outputs and caches
(summation order only: the routing, the capacity slots and the drops are
the reference's exactly); bfloat16, on identical bf16 inputs and weights,
2e-2 relative (the JAX package's own bf16 flash bound: bf16 rounds the
expert products at other points in the two frameworks, a few bf16 ulps);
the aux loss within 1e-5 relative in both (it is float32 router arithmetic
on the same inputs).  Ties in the router's top-k go to the lower expert
index in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.common import cast_tree as jax_cast_tree
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.common import cast_tree

ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]
B, S = 2, 16


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _moe_case(arch, **kw):
    """Both packages' reduced config, the JAX MoE parameters as numpy, and
    a (B, S, D) input."""
    jc, tc = jax_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    params = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(3), jc, jnp.float32))
    x = np.random.default_rng(4).standard_normal((B, S, jc.d_model)).astype(np.float32)
    return jc, tc, params, x


def _both(jc, tc, params, x, dtype, **kw):
    """``moe_ffn`` of both packages on the same parameters and input, cast
    to ``dtype`` as the trunk casts them (the router included)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp = jax_cast_tree(jax.tree.map(jnp.asarray, params), jdt)
    tp = cast_tree(params_from_numpy(params, "cpu"), tdt)
    jy, ja = jmoe.moe_ffn(jp, jnp.asarray(x).astype(jdt), jc, **kw)
    ty, ta = tmoe.moe_ffn(tp, torch.from_numpy(x).to(tdt), tc, **kw)
    assert ty.dtype == tdt and ta.dtype == torch.float32
    return (np.asarray(jy, np.float32), float(ja)), (ty.float().numpy(), float(ta))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["dispatch", "sorted"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_jax(arch, impl, dtype):
    jc, tc, params, x = _moe_case(arch, moe_impl=impl)
    (jy, ja), (ty, ta) = _both(jc, tc, params, x, dtype)
    assert _rel(ty, jy) < (1e-5 if dtype == "float32" else 2e-2)
    assert abs(ta - ja) <= 1e-5 * abs(ja) and ta > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("group_size", [4, 8])
def test_moe_ffn_drops_as_jax_does(arch, group_size):
    """Small groups give a capacity of 1-2 slots an expert: tokens drop (the
    output differs from the no-drop one), and the port drops the same ones."""
    jc, tc, params, x = _moe_case(arch)
    (jy, ja), (ty, ta) = _both(jc, tc, params, x, "float32", group_size=group_size)
    assert _rel(ty, jy) < 1e-5 and abs(ta - ja) <= 1e-5 * abs(ja)
    nodrop = dataclasses.replace(tc, capacity_factor=float(tc.n_experts) / tc.top_k)
    full, _ = tmoe.moe_ffn(params_from_numpy(params, "cpu"), torch.from_numpy(x), nodrop,
                           group_size=group_size)
    assert _rel(full.numpy(), ty) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_sorted_is_the_no_drop_dispatch(arch):
    """The dropless sorted form equals the dispatch form at a capacity that
    drops nothing (float32, summation order only)."""
    _, tc, params, x = _moe_case(arch)
    tp, xt = params_from_numpy(params, "cpu"), torch.from_numpy(x)
    nodrop = dataclasses.replace(tc, capacity_factor=float(tc.n_experts) / tc.top_k)
    a, aux_a = tmoe.moe_ffn(tp, xt, nodrop)
    b, aux_b = tmoe.moe_ffn_sorted(tp, xt, tc)
    assert _rel(b.numpy(), a.numpy()) < 1e-5 and float(aux_a) == pytest.approx(float(aux_b))


def test_top_k_breaks_ties_as_lax_top_k():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1, 0.0, 0.05], [0.125] * 8,
                      [0.0, 0.2, 0.2, 0.2, 0.2, 0.2, 0.0, 0.0]], np.float32)
    for k in (1, 2, 3, 5):
        vals, idx = tmoe._top_k(torch.from_numpy(probs), k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_is_shaped_like_jax(arch):
    """Same names, shapes and dtypes (the router float32 under a bf16 param
    dtype), stacked on a leading axis for the MoE blocks; the fan-ins the
    JAX package uses (the expert count for ``wi`` and ``wg``)."""
    jc = jax_get_config(arch).reduced()
    tc = get_config(arch).reduced()
    want = jmoe.init_moe(jax.random.PRNGKey(0), jc, jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    got = tmoe.init_moe(gen, tc, torch.bfloat16, layers=(2,))
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_w == tree_g
    for w, g in zip(flat_w, flat_g):
        assert g.shape == (2, *w.shape) and str(g.dtype).split(".")[-1] == str(w.dtype)
    assert got["router"].dtype == torch.float32
    wi = got["wi"].float()
    assert abs(float(wi.std()) * np.sqrt(tc.n_experts) / 0.88 - 1) < 0.05


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

def _mla_case(dtype="float32", **kw):
    jc = jax_get_config("deepseek-v3-671b").reduced(compute_dtype=dtype, **kw)
    tc = get_config("deepseek-v3-671b").reduced(compute_dtype=dtype, **kw)
    params = jax.tree.map(np.asarray, jattn.init_mla(jax.random.PRNGKey(5), jc, jnp.float32))
    x = np.random.default_rng(6).standard_normal((B, S, jc.d_model)).astype(np.float32)
    return jc, tc, params, x


@pytest.mark.parametrize("causal", [True, False])
def test_mla_attention_matches_jax(causal):
    jc, tc, params, x = _mla_case()
    want = jattn.mla_attention(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jc,
                               causal=causal)
    got = tattn.mla_attention(params_from_numpy(params, "cpu"), torch.from_numpy(x), tc,
                              causal=causal)
    assert got.shape == (B, S, tc.d_model)
    assert _rel(got.numpy(), want) < 1e-5


def test_mla_qkv_shapes():
    """Dk = dqn + dqr, Dv = v_head_dim, the rope key shared by every head."""
    _, tc, params, x = _mla_case()
    q, k, v, latent, k_rope = tattn._mla_qkv(params_from_numpy(params, "cpu"),
                                            torch.from_numpy(x), torch.arange(S), tc)
    dk = tc.qk_nope_head_dim + tc.qk_rope_head_dim
    assert q.shape == (B, tc.n_heads, S, dk) and k.shape == (B, tc.n_heads, S, dk)
    assert v.shape == (B, tc.n_heads, S, tc.v_head_dim)
    assert latent.shape == (B, S, tc.kv_lora_rank)
    assert k_rope.shape == (B, 1, S, tc.qk_rope_head_dim)
    assert torch.equal(k[:, 0, :, tc.qk_nope_head_dim:], k[:, -1, :, tc.qk_nope_head_dim:])


@pytest.mark.parametrize("absorb", [False, True], ids=["re-expanded", "absorbed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(absorb, dtype):
    """Token by token from a zero latent cache, both packages' decode (the
    port writes its cache in place): outputs and the cache within 1e-5 in
    float32, 2e-2 in bf16 (compute-dtype weights and cache)."""
    jc, tc, params, x = _mla_case(dtype, mla_absorb=absorb)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    jp = jax_cast_tree(jax.tree.map(jnp.asarray, params), jdt)
    tp = cast_tree(params_from_numpy(params, "cpu"), tdt)
    jcache = jattn.init_mla_cache(jc, B, S, jdt)
    tcache = tattn.init_mla_cache(tc, B, S, tdt, "cpu")
    tol = 1e-5 if dtype == "float32" else 2e-2
    for t in range(S):
        xt = x[:, t:t + 1]
        want, jcache = jattn.mla_decode(jp, jnp.asarray(xt).astype(jdt), jcache,
                                        jnp.asarray(t, jnp.int32), jc)
        got, tcache = tattn.mla_decode(tp, torch.from_numpy(xt).to(tdt), tcache, t, tc)
        assert got.dtype == tdt
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < tol, t
    assert _rel(tcache["latent"].float().numpy(), np.asarray(jcache["latent"], np.float32)) < tol


def test_mla_absorbed_and_re_expanded_decodes_agree():
    """The two decode forms are the same attention: float32 within 1e-5, and
    both match the full-sequence forward's last position."""
    _, tc, params, x = _mla_case()
    tp = params_from_numpy(params, "cpu")
    outs = []
    for absorb in (False, True):
        cfg = dataclasses.replace(tc, mla_absorb=absorb)
        cache = tattn.init_mla_cache(cfg, B, S, torch.float32, "cpu")
        steps = [tattn.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]), cache, t, cfg)[0]
                 for t in range(S)]
        outs.append(torch.cat(steps, dim=1))
    full = tattn.mla_attention(tp, torch.from_numpy(x), tc)
    assert _rel(outs[1].numpy(), outs[0].numpy()) < 1e-5
    assert _rel(outs[0].numpy(), full.numpy()) < 1e-5
