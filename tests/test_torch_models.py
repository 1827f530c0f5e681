"""The port's dense model substrate and serving engine against the JAX
package, on reduced ``phi4-mini-3.8b`` and ``qwen2.5-14b`` (QKV bias) with
the JAX parameters carried across by ``params_from_numpy``.

Tolerances: float32 compute, relative max error 1e-5 on logits (summation
order and last-ulp differences of exp/cos/sin between XLA and torch), tokens
exactly equal; bfloat16 compute, relative 3e-2 (bf16 rounds at different
points in the two frameworks: matmul outputs, silu, residual adds); the
port's own decode against its forward 2e-3, the JAX package's bound
(tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import cell_supported as jax_cell_supported
from repro.models.model_zoo import build as jax_build
from repro.serve.engine import new_instance as jax_new_instance
from repro_torch.configs.base import all_arch_names, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_supported
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import flash_attention
from repro_torch.models import build
from repro_torch.models.common import cast_tree
from repro_torch.serve import new_instance

ARCHS = ["phi4-mini-3.8b", "qwen2.5-14b"]
PORTED = ["mistral-large-123b", "phi4-mini-3.8b", "qwen2.5-14b", "qwen2.5-32b"]
B, S, N_NEW = 2, 16, 6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _setup(arch, dtype):
    """Both packages' reduced model on the same parameters (QKV biases made
    non-zero so that they count), one per (arch, dtype) and module."""
    kw = dict(compute_dtype=dtype, name=f"{arch}-{dtype}-port-parity")
    jcfg, tcfg = jax_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    jm, tm = jax_build(jcfg), build(tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    attn = tree["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (0.1 * rng.standard_normal(attn[name].shape)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    return {"jcfg": jcfg, "tcfg": tcfg, "jm": jm, "tm": tm, "tree": tree, "jp": jp,
            "tp": params_from_numpy(tree, device="cpu"), "tokens": tokens}


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            cache[arch, dtype] = _setup(arch, dtype)
        return cache[arch, dtype]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax_f32(models, arch):
    m = models(arch, "float32")
    want, _ = m["jm"].forward(m["jp"], {"tokens": jnp.asarray(m["tokens"])})
    got, aux = m["tm"].forward(m["tp"], {"tokens": torch.from_numpy(m["tokens"])})
    assert got.dtype == torch.float32 and got.shape == (B, S, m["tcfg"].padded_vocab)
    assert float(aux) == 0.0
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax_bf16(models, arch):
    m = models(arch, "bfloat16")
    want, _ = m["jm"].forward(m["jp"], {"tokens": jnp.asarray(m["tokens"])})
    got, _ = m["tm"].forward(m["tp"], {"tokens": torch.from_numpy(m["tokens"])})
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 3e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax_f32(models, arch):
    m = models(arch, "float32")
    jc = m["jm"].init_caches(m["jp"], B, S)
    tc = m["tm"].init_caches(m["tp"], B, S)
    assert tuple(tc["k"].shape) == (m["tcfg"].n_layers, *jc["k"].shape[1:])
    for t in range(S):
        tok = m["tokens"][:, t:t + 1]
        want, jc = m["jm"].decode_step(m["jp"], {"tokens": jnp.asarray(tok),
                                                 "pos": jnp.asarray(t, jnp.int32)}, jc)
        got, tc = m["tm"].decode_step(m["tp"], {"tokens": torch.from_numpy(tok), "pos": t}, tc)
        assert _rel(got.numpy(), want) < 1e-5, t
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_matches_jax(models, arch, dtype):
    m = models(arch, dtype)
    ji = jax_new_instance(m["jcfg"], m["jp"], B, S + N_NEW)
    ti = new_instance(m["tcfg"], m["tp"], B, S + N_NEW, device="cpu")
    want = ji.generate(jnp.asarray(m["tokens"]), N_NEW)
    before = flash_attention.launches
    got = ti.generate(m["tokens"], N_NEW)
    assert flash_attention.launches == before      # the engine's path is decode attention
    assert got.dtype == want.dtype and got.shape == (B, N_NEW)
    np.testing.assert_array_equal(got, want)
    assert ti.pos == ji.pos == S + N_NEW


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax_f32(models, arch):
    m = models(arch, "float32")
    want = jax_new_instance(m["jcfg"], m["jp"], B, S).prefill(jnp.asarray(m["tokens"]))
    got = new_instance(m["tcfg"], m["tp"], B, S, device="cpu").prefill(m["tokens"])
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_port_forward(models, arch):
    """The port's counterpart of tests/test_models.py::test_decode_parity."""
    m = models(arch, "float32")
    full, _ = m["tm"].forward(m["tp"], {"tokens": torch.from_numpy(m["tokens"])})
    caches = m["tm"].init_caches(m["tp"], B, S)
    dec = []
    for t in range(S):
        lg, caches = m["tm"].decode_step(
            m["tp"], {"tokens": torch.from_numpy(m["tokens"][:, t:t + 1]), "pos": t}, caches)
        dec.append(lg[:, 0])
    assert _rel(torch.stack(dec, 1).numpy(), full.numpy()) < 2e-3


def test_instance_casts_parameters_once(models):
    m = models("phi4-mini-3.8b", "bfloat16")
    inst = new_instance(m["tcfg"], m["tp"], B, S, device="cpu")
    leaves = [inst.params["layers"]["attn"]["wq"], inst.params["embed"]["head"]]
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    assert m["tp"]["layers"]["attn"]["wq"].dtype == torch.float32     # the caller's tree stays
    again = cast_tree(inst.params, torch.bfloat16)
    assert again["layers"]["attn"]["wq"] is inst.params["layers"]["attn"]["wq"]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bit_exact(models, arch):
    m = models(arch, "float32")
    back = params_to_numpy(params_from_numpy(m["tree"], device="cpu"))
    flat_a, tree_a = jax.tree.flatten(m["tree"])
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_params_from_numpy_copies():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "n": [np.ones(2, np.int32)]}
    t = params_from_numpy(tree, device="cpu")
    t["a"][0, 0] = 7.0
    assert tree["a"][0, 0] == 0.0 and t["n"][0].dtype == torch.int32


@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_jax(arch):
    jc, tc = jax_get_config(arch), get_config(arch)
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert jd == td
    for c_j, c_t in ((jc, tc), (jc.reduced(), tc.reduced()),
                     (jc.reduced(compute_dtype="float32", n_layers=3),
                      tc.reduced(compute_dtype="float32", n_layers=3))):
        assert dataclasses.asdict(c_j) == dataclasses.asdict(c_t)
        assert (c_t.head_dim, c_t.padded_vocab, c_t.param_count(), c_t.active_param_count()) == \
            (c_j.head_dim, c_j.padded_vocab, c_j.param_count(), c_j.active_param_count())
        assert str(c_t.cdtype()).split(".")[-1] == c_j.compute_dtype
        assert str(c_t.pdtype()).split(".")[-1] == c_j.param_dtype
    for name, shape in JAX_SHAPES.items():
        assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(shape)
        assert cell_supported(tc, SHAPES[name]) == jax_cell_supported(jc, shape)


def test_registry_holds_the_ported_configs():
    assert all_arch_names() == PORTED
    phi = get_config("phi4-mini-3.8b")
    assert (phi.n_layers, phi.d_model, phi.n_heads, phi.n_kv_heads, phi.head_dim, phi.d_ff,
            phi.vocab, phi.padded_vocab) == (32, 3072, 24, 8, 128, 8192, 200064, 200064)
    assert 4.4e9 < phi.param_count() < 4.5e9


def test_input_specs_and_make_batch(models):
    m = models("phi4-mini-3.8b", "float32")
    tm, jm = m["tm"], m["jm"]
    for shape in (ShapeSpec("t", 8, 2, "train"), ShapeSpec("p", 8, 2, "prefill"),
                  ShapeSpec("d", 8, 2, "decode")):
        want = jm.input_specs(shape)
        got = tm.input_specs(shape)
        assert sorted(got) == sorted(want)
        for k, spec in got.items():
            assert spec.shape == want[k].shape and str(spec.dtype).split(".")[-1] == \
                str(want[k].dtype)
        batch = tm.make_batch(np.random.default_rng(0), shape)
        jb = jm.make_batch(np.random.default_rng(0), shape)
        for k, v in batch.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(jb[k]))


def test_unported_families_raise():
    cfg = get_config("phi4-mini-3.8b")
    with pytest.raises(NotImplementedError):
        build(dataclasses.replace(cfg, n_enc_layers=2, n_dec_layers=2), device="cpu")
    moe = build(dataclasses.replace(cfg.reduced(), family="moe"), device="cpu")
    with pytest.raises(NotImplementedError):
        moe.init(0)
    mla = build(dataclasses.replace(cfg.reduced(), attn_kind="mla"), device="cpu")
    with pytest.raises(NotImplementedError):
        mla.init(0)


def test_port_init_is_seeded_and_shaped_like_jax(models):
    m = models("qwen2.5-14b", "float32")
    a, b = m["tm"].init(3), m["tm"].init(3)
    flat_j, tree_j = jax.tree.flatten(m["tree"])
    flat_a, tree_a = jax.tree.flatten(params_to_numpy(a))
    assert tree_a == tree_j
    for x, y in zip(flat_a, flat_j):
        assert x.shape == y.shape and x.dtype == y.dtype
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    wq = a["layers"]["attn"]["wq"]
    std = 1 / np.sqrt(m["tcfg"].d_model)
    assert float(wq.abs().max()) <= 2 * std and abs(float(wq.std()) / std - 0.88) < 0.05
