"""The port's model substrate and serving engine against the JAX package,
on reduced ``phi4-mini-3.8b`` and ``qwen2.5-14b`` (QKV bias), and on the MoE
family's reduced ``olmoe-1b-7b`` and ``deepseek-v3-671b`` (MLA, a shared
expert, a leading dense layer, the MTP head), with the JAX parameters carried
across by ``params_from_numpy``; all ten configs against the JAX package's
(the VLM, state-space and encoder-decoder models have files of their own:
test_torch_vlm.py, test_torch_ssm.py, test_torch_encdec.py).

Tolerances: float32 compute, relative max error 1e-5 on logits and the aux
loss (summation order and last-ulp differences of exp/cos/sin between XLA and
torch; the MoE routing and its capacity drops are the reference's exactly),
tokens exactly equal; bfloat16 compute, relative 3e-2 (bf16 rounds at
different points in the two frameworks: matmul outputs, silu, residual adds)
-- for the MoE family at every position whose routing the two frameworks
agree on: one bf16 rounding can move a token to another expert (or past an
expert's capacity), which changes that position's logits by far more, so
at most 1 in 8 positions may differ beyond 3e-2; the port's own decode
against its forward 2e-3, the JAX package's bound (tests/test_models.py),
for the MoE family at the no-drop capacity factor as the reference's own
test takes it.
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
from repro.models import transformer as jax_tf
from repro.models.model_zoo import build as jax_build
from repro.serve.engine import new_instance as jax_new_instance
from repro_torch.configs.base import all_arch_names, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_supported
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import flash_attention
from repro_torch.models import build
from repro_torch.models import transformer as tf
from repro_torch.models.common import cast_tree
from repro_torch.serve import new_instance
from repro_torch.tree import tree_leaves

ARCHS = ["phi4-mini-3.8b", "qwen2.5-14b"]
MOE_ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]
PORTED = ["deepseek-v3-671b", "mistral-large-123b", "olmoe-1b-7b", "phi4-mini-3.8b",
          "qwen2-vl-72b", "qwen2.5-14b", "qwen2.5-32b", "seamless-m4t-medium", "xlstm-125m",
          "zamba2-2.7b"]
B, S, N_NEW = 2, 16, 6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _setup(arch, dtype, **extra):
    """Both packages' reduced model on the same parameters (QKV biases made
    non-zero so that they count), one per (arch, dtype, extra) and module."""
    tag = "-".join(f"{k}{v}" for k, v in sorted(extra.items()))
    kw = dict(compute_dtype=dtype, name=f"{arch}-{dtype}-{tag}-port-parity", **extra)
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

    def get(arch, dtype, **extra):
        key = (arch, dtype, tuple(sorted(extra.items())))
        if key not in cache:
            cache[key] = _setup(arch, dtype, **extra)
        return cache[key]
    return get


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_forward_logits_match_jax_f32(models, arch):
    m = models(arch, "float32")
    want, want_aux = m["jm"].forward(m["jp"], {"tokens": jnp.asarray(m["tokens"])})
    got, aux = m["tm"].forward(m["tp"], {"tokens": torch.from_numpy(m["tokens"])})
    assert got.dtype == torch.float32 and got.shape == (B, S, m["tcfg"].padded_vocab)
    if m["tcfg"].family == "dense":
        assert float(aux) == float(want_aux) == 0.0
    else:
        assert aux.dtype == torch.float32 and float(aux) > 0
        assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax_bf16(models, arch):
    m = models(arch, "bfloat16")
    want, _ = m["jm"].forward(m["jp"], {"tokens": jnp.asarray(m["tokens"])})
    got, _ = m["tm"].forward(m["tp"], {"tokens": torch.from_numpy(m["tokens"])})
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 3e-2


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + ["deepseek-v3-671b-absorbed"])
def test_decode_steps_match_jax_f32(models, arch):
    """Token by token from empty caches (the MoE family's decode groups are
    the batch, so its capacity drops tokens as the reference's does; MLA's
    latent caches, re-expanded or absorbed): logits and every cache leaf."""
    if arch.endswith("-absorbed"):
        m = models(arch.removesuffix("-absorbed"), "float32", mla_absorb=True)
    else:
        m = models(arch, "float32")
    jc = m["jm"].init_caches(m["jp"], B, S)
    tc = m["tm"].init_caches(m["tp"], B, S)
    assert jax.tree.structure(jax.tree.map(np.asarray, jc)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), tc))
    for t in range(S):
        tok = m["tokens"][:, t:t + 1]
        want, jc = m["jm"].decode_step(m["jp"], {"tokens": jnp.asarray(tok),
                                                 "pos": jnp.asarray(t, jnp.int32)}, jc)
        got, tc = m["tm"].decode_step(m["tp"], {"tokens": torch.from_numpy(tok), "pos": t}, tc)
        assert _rel(got.numpy(), want) < 1e-5, t
    for g, w in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_generate_matches_jax_moe(models, arch):
    """``test_generate_matches_jax`` for the MoE family in float32 (the
    engine's decode drops tokens at the batch's capacity in both packages
    alike); bf16 tokens follow the routing, which one rounding can move."""
    test_generate_matches_jax(models, arch, "float32")


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_port_decode_matches_port_forward_moe_nodrop(arch):
    """The twin of tests/test_models.py::test_decode_parity_moe_nodrop: the
    port's decode against its forward at the capacity factor E / top_k, under
    which no group drops a token (dropping is group-dependent by design)."""
    base = get_config(arch).reduced(compute_dtype="float32", param_dtype="float32")
    cfg = base.reduced(compute_dtype="float32", param_dtype="float32",
                       capacity_factor=float(base.n_experts) / base.top_k)
    model = build(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, S)))
    full, _ = model.forward(params, {"tokens": tokens})
    caches = model.init_caches(params, 2, S)
    dec = []
    for t in range(S):
        lg, caches = model.decode_step(params, {"tokens": tokens[:, t:t + 1], "pos": t}, caches)
        dec.append(lg[:, 0])
    assert _rel(torch.stack(dec, 1).numpy(), full.numpy()) < 2e-3


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_bf16_matches_jax_where_routing_agrees(models, arch):
    """bf16 compute: at least 7 of 8 positions within 3e-2 of the reference
    (relative to the whole logits' max); the others are positions where one
    bf16 rounding moved a token to another expert.  The aux loss within
    3e-2."""
    m = models(arch, "bfloat16")
    want, want_aux = m["jm"].forward(m["jp"], {"tokens": jnp.asarray(m["tokens"])})
    got, aux = m["tm"].forward(m["tp"], {"tokens": torch.from_numpy(m["tokens"])})
    v = m["tcfg"].vocab
    w = np.asarray(want, np.float64)[..., :v]
    per_pos = np.abs(got.numpy()[..., :v] - w).max(-1) / np.abs(w).max()
    assert (per_pos < 3e-2).mean() >= 7 / 8, np.round(per_pos, 3)
    assert abs(float(aux) - float(want_aux)) <= 3e-2 * float(want_aux)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_mtp_matches_jax(models, dtype):
    """DeepSeek-V3's ``lm_forward_mtp``: the main and the MTP logits and the
    aux loss against the reference (float32 1e-5).  In bf16 the main logits
    as the forward's; the MTP block attends over the whole prefix, so a
    position whose routing differs moves every later MTP position: the MTP
    logits are held within 3e-2 before the first such position of each
    sequence."""
    m = models("deepseek-v3-671b", dtype)
    want = jax_tf.lm_forward_mtp(m["jp"], jnp.asarray(m["tokens"]), m["jcfg"])
    got = tf.lm_forward_mtp(m["tp"], torch.from_numpy(m["tokens"]), m["tcfg"])
    v = m["tcfg"].vocab
    per_pos = []
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == (B, S, m["tcfg"].padded_vocab) and g.dtype == torch.float32
        w = np.asarray(w, np.float64)[..., :v]
        per_pos.append(np.abs(g.numpy()[..., :v] - w).max(-1) / np.abs(w).max())
    if dtype == "float32":
        assert max(p.max() for p in per_pos) < 1e-5
    else:
        main, mtp = per_pos
        assert (main < 3e-2).mean() >= 7 / 8, np.round(main, 3)
        for row_main, row_mtp in zip(main, mtp):
            first = int(np.argmax(row_main >= 3e-2)) if (row_main >= 3e-2).any() else S
            assert first >= 4 and (row_mtp[:first] < 3e-2).all(), np.round(row_mtp, 3)
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert abs(float(got[2]) - float(want[2])) <= tol * float(want[2])
    plain = get_config("phi4-mini-3.8b").reduced(name="mtp-off-dense")
    model = build(plain, device="cpu")
    logits, mtp_logits, aux = tf.lm_forward_mtp(model.init(0), torch.from_numpy(m["tokens"]),
                                                plain)
    assert mtp_logits is None and float(aux) == 0.0 and logits.shape[:2] == (B, S)


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


def test_registry_holds_all_ten_configs():
    assert all_arch_names() == PORTED
    phi = get_config("phi4-mini-3.8b")
    assert (phi.n_layers, phi.d_model, phi.n_heads, phi.n_kv_heads, phi.head_dim, phi.d_ff,
            phi.vocab, phi.padded_vocab) == (32, 3072, 24, 8, 128, 8192, 200064, 200064)
    assert 4.4e9 < phi.param_count() < 4.5e9
    olmoe, ds = get_config("olmoe-1b-7b"), get_config("deepseek-v3-671b")
    assert (olmoe.n_layers, olmoe.d_model, olmoe.n_experts, olmoe.top_k, olmoe.d_ff_expert,
            olmoe.vocab, olmoe.param_count()) == (16, 2048, 64, 8, 1024, 50304, 6_919_028_736)
    assert (ds.attn_kind, ds.d_model, ds.n_heads, ds.q_lora_rank, ds.kv_lora_rank,
            ds.n_experts, ds.n_shared_experts, ds.top_k, ds.n_dense_layers, ds.mtp) == \
        ("mla", 7168, 128, 1536, 512, 256, 1, 8, 3, True)
    cut = dataclasses.replace(ds, n_layers=2, n_dense_layers=1)
    assert 13.9e9 < cut.param_count() < 14.0e9
    vl, xl = get_config("qwen2-vl-72b"), get_config("xlstm-125m")
    zb, sm = get_config("zamba2-2.7b"), get_config("seamless-m4t-medium")
    assert (vl.family, vl.d_model, vl.n_heads, vl.n_kv_heads, vl.d_ff, vl.vocab, vl.qkv_bias,
            vl.mrope, vl.vision_prefix, vl.vision_grid) == \
        ("vlm", 8192, 64, 8, 29568, 152064, True, True, 256, (16, 16))
    assert (xl.family, xl.n_layers, xl.d_model, xl.ssm_heads, xl.ssm_head_dim) == \
        ("ssm", 12, 768, 4, 192)
    assert (zb.family, zb.n_layers, zb.attn_every, zb.d_model, zb.head_dim, zb.ssm_heads,
            zb.ssm_head_dim, zb.ssm_state) == ("hybrid", 54, 6, 2560, 80, 40, 128, 64)
    assert (sm.is_encdec, sm.n_enc_layers, sm.n_dec_layers, sm.d_model, sm.n_heads,
            sm.head_dim, sm.vocab) == (True, 12, 12, 1024, 16, 64, 256206)


@pytest.mark.parametrize("arch", PORTED)
def test_full_configs_param_counts(arch):
    """The twin of tests/test_models.py::test_full_configs_param_counts: the
    analytic count in the advertised ballpark, and the reference's."""
    expected = {
        "qwen2-vl-72b": 72e9, "qwen2.5-32b": 32e9, "qwen2.5-14b": 14e9,
        "mistral-large-123b": 123e9, "phi4-mini-3.8b": 3.8e9,
        "xlstm-125m": 125e6, "deepseek-v3-671b": 671e9,
        "olmoe-1b-7b": 7e9, "zamba2-2.7b": 2.7e9,
        "seamless-m4t-medium": 1.2e9,
    }[arch]
    n = get_config(arch).param_count()
    assert 0.5 * expected < n < 1.7 * expected and n == jax_get_config(arch).param_count()


def test_long_500k_cell_support_flags():
    """The twin of tests/test_models.py::test_long_500k_cell_support_flags."""
    runs = {a: cell_supported(get_config(a), SHAPES["long_500k"])[0] for a in all_arch_names()}
    assert runs == {
        "qwen2-vl-72b": False, "qwen2.5-32b": False, "qwen2.5-14b": False,
        "mistral-large-123b": False, "phi4-mini-3.8b": False,
        "xlstm-125m": True, "deepseek-v3-671b": False, "olmoe-1b-7b": False,
        "zamba2-2.7b": True, "seamless-m4t-medium": False,
    }


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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_is_seeded_and_shaped_like_jax(models, arch):
    """The MoE family's tree: the leading dense layers a list, the MoE
    blocks stacked, the MTP module, the router float32 under any param
    dtype; the port's own init seeded."""
    m = models(arch, "float32")
    a, b = m["tm"].init(3), m["tm"].init(3)
    flat_j, tree_j = jax.tree.flatten(m["tree"])
    flat_a, tree_a = jax.tree.flatten(params_to_numpy(a))
    assert tree_a == tree_j
    for x, y in zip(flat_a, flat_j):
        assert x.shape == y.shape and x.dtype == y.dtype
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    cfg = m["tcfg"]
    assert isinstance(a.get("dense_layers", []), list)
    assert len(a.get("dense_layers", [])) == cfg.n_dense_layers
    assert ("mtp" in a) == cfg.mtp
    bf = build(dataclasses.replace(cfg, param_dtype="bfloat16"), device="cpu").init(0)
    assert bf["layers"]["moe"]["router"].dtype == torch.float32
    assert bf["layers"]["moe"]["wi"].dtype == torch.bfloat16
