"""The port's encoder-decoder (SeamlessM4T: stub frame embeddings, a
non-causal encoder, decoder blocks with cross attention) against the JAX
package on the reduced ``seamless-m4t-medium``, the JAX parameters carried
across by ``params_from_numpy``.

Tolerances as tests/test_torch_models.py: float32 logits relative 1e-5,
caches rtol = atol = 1e-5, the modules alone 1e-5, tokens equal; bf16 logits
relative 3e-2; the port's decode against its own forward 2e-3, the JAX
package's bound (tests/test_models.py::test_decode_parity_encdec)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jax_encdec
from repro.serve.engine import new_instance as jax_new_instance
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import flash_attention
from repro_torch.models import encdec
from repro_torch.models.common import cast_tree
from repro_torch.serve import new_instance
from repro_torch.tree import tree_leaves
from torch_model_pairs import (B, assert_caches_close, decode_pair, forward_pair, make_pair,
                               port_decode_logits, rel)

ARCH = "seamless-m4t-medium"
S, N_NEW = 16, 6


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = make_pair(ARCH, dtype, S)
        return cache[dtype]
    return get


def _layer0(tree):
    return jax.tree.map(lambda t: t[0], tree)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_forward_logits_match_jax(pairs, dtype, tol):
    got, want = forward_pair(pairs(dtype))
    assert rel(got, want) < tol


def test_encode_matches_jax(pairs):
    m = pairs("float32")
    want = jax_encdec.encode(m["jp"], jnp.asarray(m["frames"]), m["jcfg"])
    got = encdec.encode(m["tp"], torch.from_numpy(m["frames"]), m["tcfg"])
    assert got.shape == want.shape and rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("sq", [1, 5, 16, 40])
def test_cross_attn_matches_jax(pairs, sq):
    """One decoder layer's cross attention alone: queries of ``sq``
    positions over the encoder's 16 frames (Sq < Skv, = and >, and one query
    as at decode), non-causal."""
    m = pairs("float32")
    jcross = _layer0(m["jp"]["dec_layers"]["cross"])
    tcross = params_from_numpy(_layer0(m["tree"]["dec_layers"]["cross"]), device="cpu")
    x = np.random.default_rng(sq).standard_normal((B, sq, m["tcfg"].d_model)).astype(np.float32)
    enc = jnp.asarray(m["frames"])
    jk, jv = jax_encdec.cross_kv(jcross, enc, m["jcfg"])
    tk, tv = encdec.cross_kv(tcross, torch.from_numpy(m["frames"]), m["tcfg"])
    assert rel(tk.numpy(), jk) < 1e-5 and rel(tv.numpy(), jv) < 1e-5
    want = jax_encdec.cross_attn(jcross, jnp.asarray(x), jk, jv, m["jcfg"])
    got = encdec.cross_attn(tcross, torch.from_numpy(x), tk, tv, m["tcfg"])
    assert got.shape == want.shape and rel(got.numpy(), want) < 1e-5


def test_decode_from_zero_cross_caches_matches_jax(pairs):
    """The serving engine's start: zero cross K/V of ``max_len`` frames."""
    m = pairs("float32")
    jc = m["jm"].init_caches(m["jp"], B, S)
    tc = m["tm"].init_caches(m["tp"], B, S)
    assert tuple(tc["cross"].shape) == (m["tcfg"].n_dec_layers, 2, B, m["tcfg"].n_heads, S,
                                        m["tcfg"].head_dim)
    worst, jc, tc = decode_pair(m, jc, tc, S)
    assert worst < 1e-5
    assert_caches_close(tc, jc)


def test_decode_from_encoder_output_matches_jax(pairs):
    """``init_caches(enc_out=encode(frames))``: the cross K/V from the
    encoder, then token by token."""
    m = pairs("float32")
    jenc = jax_encdec.encode(m["jp"], jnp.asarray(m["frames"]), m["jcfg"])
    tenc = encdec.encode(m["tp"], torch.from_numpy(m["frames"]), m["tcfg"])
    jc = m["jm"].init_caches(m["jp"], B, S, enc_out=jenc)
    tc = m["tm"].init_caches(m["tp"], B, S, enc_out=tenc)
    assert_caches_close(tc, jc)
    worst, jc, tc = decode_pair(m, jc, tc, S)
    assert worst < 1e-5
    assert_caches_close(tc, jc)


def test_port_decode_matches_port_forward(pairs):
    """The twin of tests/test_models.py::test_decode_parity_encdec."""
    m = make_pair(ARCH, "float32", S, param_dtype="float32")
    model, params = m["tm"], m["tp"]
    tokens, frames = torch.from_numpy(m["tokens"]), torch.from_numpy(m["frames"])
    full, _ = model.forward(params, {"tokens": tokens, "frames": frames})
    caches = model.init_caches(params, B, S, enc_out=encdec.encode(params, frames, m["tcfg"]))
    dec = port_decode_logits(model, params, tokens, caches)
    assert rel(dec.numpy(), full.numpy()) < 2e-3


def test_generate_matches_jax(pairs):
    """The reference engine serves an encoder-decoder from zero cross
    caches; so does the port's, token for token."""
    m = pairs("float32")
    ji = jax_new_instance(m["jcfg"], m["jp"], B, S + N_NEW)
    ti = new_instance(m["tcfg"], m["tp"], B, S + N_NEW, device="cpu")
    want = ji.generate(jnp.asarray(m["tokens"]), N_NEW)
    before = flash_attention.launches
    got = ti.generate(m["tokens"], N_NEW)
    assert flash_attention.launches == before       # CPU tensors: the plain versions
    np.testing.assert_array_equal(got, want)
    assert ti.pos == ji.pos == S + N_NEW


def test_init_is_seeded_and_shaped_like_jax(pairs):
    m = pairs("float32")
    a, b = m["tm"].init(3), m["tm"].init(3)
    flat_j, tree_j = jax.tree.flatten(m["tree"])
    flat_a, tree_a = jax.tree.flatten(params_to_numpy(a))
    assert tree_a == tree_j
    for x, y in zip(flat_a, flat_j):
        assert x.shape == y.shape and x.dtype == y.dtype
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_input_specs_and_make_batch_equal_jax(pairs):
    m = pairs("float32")
    for shape in (ShapeSpec("t", 8, 2, "train"), ShapeSpec("p", 8, 2, "prefill"),
                  ShapeSpec("d", 8, 2, "decode")):
        want, got = m["jm"].input_specs(shape), m["tm"].input_specs(shape)
        assert sorted(got) == sorted(want)
        for k, spec in got.items():
            assert spec.shape == want[k].shape
            assert str(spec.dtype).split(".")[-1] == str(want[k].dtype)
        batch = m["tm"].make_batch(np.random.default_rng(0), shape)
        jb = m["jm"].make_batch(np.random.default_rng(0), shape)
        assert sorted(batch) == sorted(jb)
        for k, v in batch.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(jb[k]))


def test_cast_caches_once(pairs):
    """The cross K/V come from the compute-dtype parameters, as the
    reference's ``cast_tree`` inside ``init_encdec_caches``."""
    m = pairs("bfloat16")
    tenc = encdec.encode(m["tp"], torch.from_numpy(m["frames"]), m["tcfg"])
    tc = m["tm"].init_caches(m["tp"], B, S, enc_out=tenc)
    assert tc["cross"].dtype == torch.bfloat16 and tc["self"]["k"].dtype == torch.bfloat16
    cross0 = _layer0(cast_tree(m["tp"], torch.bfloat16)["dec_layers"]["cross"])
    k, _ = encdec.cross_kv(cross0, tenc, m["tcfg"])
    assert torch.equal(tc["cross"][0, 0], k)
