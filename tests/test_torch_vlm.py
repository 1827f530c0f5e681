"""The port's VLM family (Qwen2-VL: M-RoPE, a stub vision prefix, QKV bias)
against the JAX package on the reduced ``qwen2-vl-72b`` (a 16-patch 4x4
prefix), the JAX parameters carried across by ``params_from_numpy``.

Tolerances as tests/test_torch_models.py: float32 logits relative 1e-5,
caches rtol = atol = 1e-5, tokens equal; bf16 logits relative 3e-2; the
port's decode against its own forward 2e-5, the JAX package's bound
(tests/test_models.py::test_decode_parity_vlm)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import new_instance as jax_new_instance
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels import flash_attention
from repro_torch.models import transformer as tf
from repro_torch.models.common import embed
from repro_torch.serve import new_instance
from torch_model_pairs import (B, assert_caches_close, decode_pair, forward_pair, make_pair,
                               port_decode_logits, rel)

ARCH = "qwen2-vl-72b"
S, N_NEW = 24, 6          # 16 vision positions, then text


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = make_pair(ARCH, dtype, S)
        return cache[dtype]
    return get


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_forward_with_vision_embeds_matches_jax(pairs, dtype, tol):
    m = pairs(dtype)
    got, want = forward_pair(m)
    assert rel(got, want) < tol


def test_forward_without_vision_embeds_matches_jax(pairs):
    """No ``vision_embeds``: the token embeddings stay, M-RoPE positions all the same."""
    m = pairs("float32")
    want, _ = m["jm"].forward(m["jp"], {"tokens": jnp.asarray(m["tokens"])})
    got, _ = m["tm"].forward(m["tp"], {"tokens": torch.from_numpy(m["tokens"])})
    assert rel(got.numpy(), want) < 1e-5


def test_decode_steps_and_caches_match_jax(pairs):
    m = pairs("float32")
    jc = m["jm"].init_caches(m["jp"], B, S)
    tc = m["tm"].init_caches(m["tp"], B, S)
    worst, jc, tc = decode_pair(m, jc, tc, S)
    assert worst < 1e-5
    assert_caches_close(tc, jc)


@pytest.mark.parametrize("pos", [0, 1, 5, 15, 16, 17, 23, 300])
def test_decode_mrope_ids_are_the_references(pairs, pos):
    """The host's ids for one position against the reference's ``jnp.where``
    on a traced position: the raster inside the prefix, then all three
    components ``pos - vision_prefix + max(grid)``."""
    cfg = pairs("float32")["tcfg"]
    gh, gw = cfg.vision_grid
    vp, mx = cfg.vision_prefix, max(cfg.vision_grid)
    p = jnp.asarray(pos, jnp.int32)
    is_vis = p < vp
    want = np.stack([np.asarray(jnp.where(is_vis, 0, p - vp + mx)),
                     np.asarray(jnp.where(is_vis, p // gw, p - vp + mx)),
                     np.asarray(jnp.where(is_vis, p % gw, p - vp + mx))])[:, None]
    got = tf.mrope_pos3(cfg, pos, "cpu")
    assert got.dtype == torch.int32 and got.shape == (3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_decode_matches_port_forward():
    """The twin of tests/test_models.py::test_decode_parity_vlm: the full
    M-RoPE decode path equals the forward when the vision embeds are the
    token embeddings (the modality difference removed, the position math
    kept)."""
    m = make_pair(ARCH, "float32", 32, param_dtype="float32")
    model, params = m["tm"], m["tp"]
    tokens = torch.from_numpy(m["tokens"])
    vis = embed(params["embed"], tokens[:, :m["tcfg"].vision_prefix], torch.float32)
    full, _ = model.forward(params, {"tokens": tokens, "vision_embeds": vis})
    dec = port_decode_logits(model, params, tokens, model.init_caches(params, B, 32))
    assert rel(dec.numpy(), full.numpy()) < 2e-5


def test_generate_matches_jax(pairs):
    m = pairs("float32")
    ji = jax_new_instance(m["jcfg"], m["jp"], B, S + N_NEW)
    ti = new_instance(m["tcfg"], m["tp"], B, S + N_NEW, device="cpu")
    want = ji.generate(jnp.asarray(m["tokens"]), N_NEW)
    before = flash_attention.launches
    got = ti.generate(m["tokens"], N_NEW)
    assert flash_attention.launches == before      # the engine's path is decode attention
    np.testing.assert_array_equal(got, want)
    assert ti.pos == ji.pos == S + N_NEW


def test_input_specs_and_make_batch_equal_jax(pairs):
    m = pairs("float32")
    for shape in (ShapeSpec("t", 24, 2, "train"), ShapeSpec("p", 24, 2, "prefill"),
                  ShapeSpec("d", 24, 2, "decode")):
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
