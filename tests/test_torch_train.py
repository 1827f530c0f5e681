"""The port's training substrate against the JAX package: AdamW, the
learning-rate schedule and the global norm, the train step's loss and
gradients, 30 steps of training, int8 gradient compression with error
feedback, and the synthetic data pipeline.  Twins of ``tests/test_train.py``
(its optimizer, dense-training, compression and data tests) on the reference
test's ``TINY`` (qwen2.5-14b reduced, QKV bias), the JAX parameters carried
across by ``interop.train_state_from_numpy``.

Tolerances: the update's moments ``==`` and its parameters within 1 ulp of
the reference's on identical gradients (the same float32 operations in the
same order; XLA may contract the last multiply-add); ``lr_schedule`` ``==``;
``global_norm`` ``==`` on the reference test's tree and within 1 ulp on
random ones (the leaves' sums are added in the reference's order, but each
framework sums inside a leaf in its own order); in float32 compute the loss
and every gradient leaf within 1e-5 relative (summation order), and each of
30 losses within 1e-4 relative; in bf16 compute the first loss within 3e-2
(bf16 rounds at other points in the two frameworks); int8 bits and scales
``==`` (both round half to even); data batches ``==``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models.model_zoo import build as jax_build
from repro.sharding.collectives import quantize_int8 as jax_quantize_int8
from repro.train import optimizer as jopt
from repro.train.trainstep import init_train_state as jax_init_train_state
from repro.train.trainstep import make_loss_fn as jax_make_loss_fn
from repro.train.trainstep import make_train_step as jax_make_train_step
from repro_torch.configs.base import get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.models import build
from repro_torch.sharding import ErrorFeedback, dequantize_int8, quantize_int8
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_update,
    global_norm,
    init_adamw,
    lr_schedule,
)
from repro_torch.train.trainstep import (
    TrainState,
    init_train_state,
    make_loss_fn,
    make_train_step,
)
from repro_torch.tree import tree_leaves

TINY_KW = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=128, d_head=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These steps are many small ops: with the suite's workers on the same
    cores, torch's default of a thread a core makes them wait on each other
    (a step ran 70x slower in a full run than alone).  One thread here, the
    old count restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _setup(dtype: str) -> dict:
    """Both packages' TINY in one compute dtype, the JAX train state and its
    numpy twin, and a data stream."""
    kw = dict(TINY_KW, compute_dtype=dtype, name=f"tiny-train-{dtype}-parity")
    jcfg = jax_get_config("qwen2.5-14b").reduced(**kw)
    tcfg = get_config("qwen2.5-14b").reduced(**kw)
    jm, tm = jax_build(jcfg), build(tcfg, device="cpu")
    jstate = jax_init_train_state(jm, jax.random.PRNGKey(0))
    data = SyntheticLMData(DataConfig(vocab=tcfg.vocab, seq_len=64, global_batch=8))
    return {"dtype": dtype, "jm": jm, "tm": tm, "jstate": jstate,
            "tree": jax.tree.map(np.asarray, jstate), "data": data}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def tiny(request):
    """``_setup`` in each compute dtype, with the JAX train step jitted (one
    compile each)."""
    s = _setup(request.param)
    s["jstep"] = jax.jit(jax_make_train_step(s["jm"]))
    return s


@pytest.fixture(scope="module")
def tiny_f32():
    return _setup("float32")


# --------------------------------------------------------------------------
# optimizer (twins of tests/test_train.py::TestOptimizer, against JAX too)
# --------------------------------------------------------------------------

class TestOptimizer:
    def test_adamw_matches_reference_step(self):
        """One AdamW step vs a hand-rolled numpy reference and vs JAX's."""
        kw = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.1, clip_norm=1e9,
                  min_lr_ratio=1.0)
        p = {"w": torch.tensor([[1.0, -2.0]])}
        g = {"w": torch.tensor([[0.5, 0.25]])}
        new_p, new_state, _ = adamw_update(AdamWConfig(**kw), g, init_adamw(p), p)
        m = 0.1 * np.array([[0.5, 0.25]])
        v = 0.05 * np.array([[0.5, 0.25]]) ** 2
        mh = m / (1 - 0.9)
        vh = v / (1 - 0.95)
        ref = np.array([[1.0, -2.0]]) - 1e-2 * (mh / (np.sqrt(vh) + 1e-8)
                                                + 0.1 * np.array([[1.0, -2.0]]))
        np.testing.assert_allclose(new_p["w"].numpy(), ref, rtol=1e-5)
        jp = {"w": jnp.asarray([[1.0, -2.0]], jnp.float32)}
        want, jstate, _ = jopt.adamw_update(jopt.AdamWConfig(**kw),
                                            {"w": jnp.asarray([[0.5, 0.25]], jnp.float32)},
                                            jopt.init_adamw(jp), jp)
        assert _ulps(new_p["w"].numpy(), want["w"]) <= 1
        np.testing.assert_array_equal(new_state.m["w"].numpy(), np.asarray(jstate.m["w"]))
        assert int(new_state.step) == int(jstate.step) == 1

    def test_clip_and_schedule(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
        assert float(lr_schedule(cfg, torch.tensor(5))) == pytest.approx(0.5)
        assert float(lr_schedule(cfg, torch.tensor(100))) == pytest.approx(0.1, abs=1e-3)
        g = {"a": torch.full((10,), 10.0)}
        n = float(global_norm(g))
        assert n == pytest.approx(np.sqrt(1000.0))
        assert n == float(jopt.global_norm({"a": jnp.full((10,), 10.0)}))

    def test_weight_decay_skips_1d(self):
        cfg = AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=1.0, clip_norm=1e9,
                          min_lr_ratio=1.0)
        p = {"scale": torch.ones((4,)), "w": torch.ones((2, 2))}
        g = {k: torch.zeros_like(t) for k, t in p.items()}
        new_p, _, _ = adamw_update(cfg, g, init_adamw(p), p)
        np.testing.assert_allclose(new_p["scale"].numpy(), 1.0)   # no decay
        assert float(new_p["w"][0, 0]) < 1.0                       # decayed


@pytest.mark.parametrize("cfg_kw", [{}, dict(warmup_steps=0, min_lr_ratio=0.3, lr=1e-3),
                                    dict(warmup_steps=7, total_steps=40, lr=2.0)],
                         ids=["default", "no-warmup", "short"])
def test_lr_schedule_equals_jax(cfg_kw):
    tcfg, jcfg = AdamWConfig(**cfg_kw), jopt.AdamWConfig(**cfg_kw)
    steps = [0, 1, 2, 5, 6, 7, 8, 50, 99, 100, 101, 1000, 5000, 9999, 10000, 20000]
    got = [lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32)).numpy() for s in steps]
    want = [np.asarray(jopt.lr_schedule(jcfg, jnp.asarray(s, jnp.int32))) for s in steps]
    np.testing.assert_array_equal(np.array(got), np.array(want))


def test_global_norm_adds_leaves_in_the_references_order():
    """``==`` on trees of one-element leaves whose sums round differently in
    other orders, keys inserted out of order; within 1 ulp on random leaves."""
    rng = np.random.default_rng(0)
    equal = 0
    for _ in range(40):
        keys = [f"k{i}" for i in rng.permutation(7)]
        tree = {k: np.array([rng.choice([3e3, 1.0, 7e-3]) * rng.standard_normal()], np.float32)
                for k in keys}
        got = global_norm(params_from_numpy(tree, "cpu")).numpy()
        want = np.asarray(jopt.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
        assert _ulps(got, want) <= 1
        equal += bool(got == want)
    assert equal >= 36        # an XLA fused multiply-add can round the last one once
    tree = {k: rng.standard_normal(n).astype(np.float32) for k, n in (("b", 1000), ("a", 77))}
    assert _ulps(global_norm(params_from_numpy(tree, "cpu")).numpy(),
                 jopt.global_norm({k: jnp.asarray(v) for k, v in tree.items()})) <= 1


def test_adamw_update_matches_jax_on_identical_grads(tiny_f32):
    """The reference's first-step gradients fed to both updates (clipping
    off, so that the update's own arithmetic is compared): moments ``==``,
    parameters within 1 ulp, step and learning rate ``==``, the gradient
    norm over the model's leaves within 1e-6 relative (sums inside leaves of
    thousands of elements, each framework in its own order)."""
    tiny = tiny_f32
    jm, jstate = tiny["jm"], tiny["jstate"]
    batch = {k: jnp.asarray(v) for k, v in tiny["data"].batch_at(0).items()}
    (_, _), jg = jax.value_and_grad(jax_make_loss_fn(jm), has_aux=True)(jstate.params, batch)
    kw = dict(clip_norm=1e9)
    jp, jo, jmet = jopt.adamw_update(jopt.AdamWConfig(**kw), jg, jstate.opt, jstate.params)
    tstate = train_state_from_numpy(tiny["tree"], device="cpu")
    grads = params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")
    tp, to, tmet = adamw_update(AdamWConfig(**kw), grads, tstate.opt, tstate.params)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert _ulps(a.numpy(), b) <= 1
    for t, j in ((to.m, jo.m), (to.v, jo.v)):
        for a, b in zip(tree_leaves(t), jax.tree.leaves(j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(to.step) == int(jo.step) == 1
    assert float(tmet["lr"]) == float(jmet["lr"])
    assert _rel(tmet["grad_norm"].numpy(), jmet["grad_norm"]) < 1e-6


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def test_first_step_loss_and_grads_match_jax(tiny):
    """``jax.value_and_grad`` of the reference loss against the port's loss
    and ``backward`` on the same parameters and batch."""
    jm, jstate = tiny["jm"], tiny["jstate"]
    batch = tiny["data"].batch_at(0)
    (jl, _), jg = jax.value_and_grad(jax_make_loss_fn(jm), has_aux=True)(
        jstate.params, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = params_from_numpy(tiny["tree"].params, "cpu")
    for t in tree_leaves(leaves):
        t.requires_grad_(True)
    tl, extra = make_loss_fn(tiny["tm"])(leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    tl.backward()
    tl = tl.detach()
    if tiny["dtype"] == "bfloat16":
        assert abs(float(tl) - float(jl)) <= 3e-2 * abs(float(jl))
        return
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(extra["aux"]) == 0.0
    for (path, g), t in zip(jax.tree_util.tree_leaves_with_path(jg), tree_leaves(leaves)):
        assert t.grad is not None and t.grad.shape == g.shape
        assert _rel(t.grad.numpy(), g) < 1e-5, jax.tree_util.keystr(path)


def test_thirty_steps_fall_and_track_jax(tiny):
    """30 steps from the same state through both jitted/eager train steps:
    the loss falls by more than 0.1 in both, and in float32 compute each
    loss is within 1e-4 relative of the reference's."""
    jstep, tstep = tiny["jstep"], make_train_step(tiny["tm"])
    jstate = tiny["jstate"]
    tstate = train_state_from_numpy(tiny["tree"], device="cpu")
    jl, tl = [], []
    for i in range(30):
        b = tiny["data"].batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert set(tm) == set(jm) == {"loss", "aux", "grad_norm", "lr"}
    assert tl[-1] < tl[0] - 0.1 and jl[-1] < jl[0] - 0.1, tl[::10]
    assert np.isfinite(tl).all()
    assert int(tstate.opt.step) == 30
    if tiny["dtype"] == "float32":
        assert max(abs(a - b) / abs(b) for a, b in zip(tl, jl)) < 1e-4


def test_loss_decreases_from_the_ports_own_init():
    """The twin of ``TestTraining.test_loss_decreases``: the port's own
    seeded parameters, bf16 compute."""
    cfg = get_config("qwen2.5-14b").reduced(**TINY_KW)
    model = build(cfg, device="cpu")
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8))
    step = make_train_step(model)
    state = init_train_state(model, 0)
    losses = []
    for i in range(30):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses[::10]
    assert not np.isnan(losses[-1])


def _moe_setup(arch: str) -> dict:
    """The reference test's MoE configs (``tests/test_train.py:79-101``:
    reduced, vocab 128, float32 compute here), both packages' models, the
    JAX train state and a batch of 4 x 32 tokens."""
    kw = dict(vocab=128, compute_dtype="float32", name=f"{arch}-train-parity")
    jcfg, tcfg = jax_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    jm, tm = jax_build(jcfg), build(tcfg, device="cpu")
    jstate = jax_init_train_state(jm, jax.random.PRNGKey(0))
    data = SyntheticLMData(DataConfig(vocab=tcfg.vocab, seq_len=32, global_batch=4))
    return {"jm": jm, "tm": tm, "jstate": jstate, "tree": jax.tree.map(np.asarray, jstate),
            "batch": data.batch_at(0)}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"], ids=["moe", "moe-mtp"])
def test_moe_and_mtp_loss_and_grads_match_jax(arch):
    """The twins of ``TestTraining.test_moe_train_step_runs_with_aux`` and
    ``test_mtp_train_step``: the MoE objective (CE + z-loss + aux) and
    DeepSeek-V3's (+ the MTP loss on token t+2), ``jax.value_and_grad`` of
    the reference loss against the port's loss and ``backward`` on the same
    parameters and batch: loss, aux, mtp and every gradient leaf within 1e-5
    relative in float32."""
    m = _moe_setup(arch)
    jm, jstate = m["jm"], m["jstate"]
    (jl, jx), jg = jax.value_and_grad(jax_make_loss_fn(jm), has_aux=True)(
        jstate.params, {k: jnp.asarray(v) for k, v in m["batch"].items()})
    leaves = params_from_numpy(m["tree"].params, "cpu")
    for t in tree_leaves(leaves):
        t.requires_grad_(True)
    tl, extra = make_loss_fn(m["tm"])(leaves, {k: torch.from_numpy(v)
                                               for k, v in m["batch"].items()})
    tl.backward()
    tl = tl.detach()
    assert set(extra) == set(jx) == ({"aux", "mtp"} if m["tm"].cfg.mtp else {"aux"})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k, v in extra.items():
        v = float(v.detach())
        assert v > 0 and abs(v - float(jx[k])) <= 1e-5 * abs(float(jx[k])), k
    n = 0
    for (path, g), t in zip(jax.tree_util.tree_leaves_with_path(jg), tree_leaves(leaves)):
        assert t.grad is not None and t.grad.shape == g.shape, jax.tree_util.keystr(path)
        assert _rel(t.grad.numpy(), g) < 1e-5, jax.tree_util.keystr(path)
        n += 1
    assert n == len(jax.tree.leaves(jg))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"], ids=["moe", "moe-mtp"])
def test_moe_and_mtp_train_steps_track_jax(arch):
    """Three train steps (AdamW included) through both packages from the same
    state: the metrics' keys, and each step's loss, aux, mtp and gradient
    norm within 1e-4 relative (as the dense 30-step test)."""
    m = _moe_setup(arch)
    jstep, tstep = jax.jit(jax_make_train_step(m["jm"])), make_train_step(m["tm"])
    jstate, tstate = m["jstate"], train_state_from_numpy(m["tree"], device="cpu")
    data = SyntheticLMData(DataConfig(vocab=m["tm"].cfg.vocab, seq_len=32, global_batch=4))
    for i in range(3):
        b = data.batch_at(i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(tmet) == set(jmet)
        for k in set(jmet) - {"lr"}:
            assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-4 * abs(float(jmet[k])), (i, k)
    assert int(tstate.opt.step) == 3


def test_train_step_remat_recomputes_each_block(monkeypatch):
    """With ``remat`` on, a train step runs each block's forward twice (the
    recompute in the backward) and gives the gradients it gives without."""
    from repro_torch.models import transformer

    calls = []
    block = transformer.dense_block

    def counting(*a, **kw):
        calls.append(1)
        return block(*a, **kw)

    monkeypatch.setattr(transformer, "dense_block", counting)
    grads = []
    for remat in (False, True):
        cfg = get_config("qwen2.5-14b").reduced(**TINY_KW, compute_dtype="float32", remat=remat)
        model = build(cfg, device="cpu")
        params = model.init(3)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        batch = {k: torch.from_numpy(v) for k, v in SyntheticLMData(
            DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)).batch_at(0).items()}
        calls.clear()
        loss, _ = make_loss_fn(model)(params, batch)
        loss.backward()
        assert len(calls) == cfg.n_layers * (2 if remat else 1)
        grads.append([t.grad for t in tree_leaves(params)])
        with torch.no_grad():
            calls.clear()
            model.forward(params, batch)
            assert len(calls) == cfg.n_layers            # no autograd: no recompute
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------
# gradient compression (twins of TestGradCompression)
# --------------------------------------------------------------------------

class TestGradCompression:
    @given(st.integers(0, 1000))
    @settings(max_examples=20, deadline=None)
    def test_int8_roundtrip_error_bound(self, seed):
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal((64,)) * rng.uniform(0.01, 100)).astype(np.float32)
        q, s = quantize_int8(torch.from_numpy(x))
        back = dequantize_int8(q, s)
        assert float((back - torch.from_numpy(x)).abs().max()) <= float(s) * 0.5 + 1e-9
        jq, js = jax_quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy() == np.asarray(js)

    def test_int8_rounds_half_to_even_like_jax(self):
        x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 0.0], np.float32)
        q, s = quantize_int8(torch.from_numpy(x))
        jq, js = jax_quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(q.numpy(), [127, 0, 2, 2, 0, -2, 4, 0])
        assert s.numpy() == np.asarray(js) == np.float32(1.0)

    def test_error_feedback_converges(self):
        """EF-compressed grads still train (loss decreases)."""
        cfg = get_config("qwen2.5-14b").reduced(**TINY_KW)
        model = build(cfg, device="cpu")
        data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8))
        state = init_train_state(model, 0)
        ef = ErrorFeedback(state.params)
        step = make_train_step(model, grad_transform=ef)
        losses = []
        for i in range(15):
            batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0]
        assert all(r.dtype == torch.float32 for r in tree_leaves(ef.residual))


# --------------------------------------------------------------------------
# the data pipeline (twins of TestDataPipeline, and == the reference's)
# --------------------------------------------------------------------------

class TestDataPipeline:
    @pytest.mark.parametrize("shards", [1, 2, 4])
    def test_batches_equal_the_references(self, shards):
        cfg = dict(vocab=1000, seq_len=32, global_batch=8, seed=3)
        for shard in range(shards):
            ours = SyntheticLMData(DataConfig(**cfg), shard=shard, num_shards=shards)
            ref = JaxData(JaxDataConfig(**cfg), shard=shard, num_shards=shards)
            for step in (0, 1, 17, 1000):
                a, b = ours.batch_at(step), ref.batch_at(step)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])

    def test_determinism_and_skip_ahead(self):
        cfg = DataConfig(vocab=1000, seq_len=32, global_batch=8)
        a = SyntheticLMData(cfg)
        b = SyntheticLMData(cfg)
        np.testing.assert_array_equal(a.batch_at(17)["tokens"], b.batch_at(17)["tokens"])
        it = iter(a)
        for step in range(3):
            np.testing.assert_array_equal(next(it)["labels"], b.batch_at(step)["labels"])

    def test_shards_partition_global_batch(self):
        cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8)
        shards = [SyntheticLMData(cfg, shard=i, num_shards=4) for i in range(4)]
        batches = [s.batch_at(3)["tokens"] for s in shards]
        assert all(b.shape == (2, 16) for b in batches)
        assert not np.array_equal(batches[0], batches[1])

    def test_restart_resumes_identical_stream(self):
        cfg = DataConfig(vocab=1000, seq_len=16, global_batch=4)
        run1 = [SyntheticLMData(cfg).batch_at(i)["tokens"] for i in range(5)]
        restarted = SyntheticLMData(cfg)
        run2 = [restarted.batch_at(i)["tokens"] for i in range(5)]
        for x, y in zip(run1, run2):
            np.testing.assert_array_equal(x, y)


def test_train_state_carries_across_bit_for_bit(tiny):
    """``interop.train_state_from_numpy`` / ``_to_numpy`` keep every bit and
    the reference's tree shape (its ``TrainState`` of ``AdamWState``)."""
    from repro_torch.interop import train_state_to_numpy

    tstate = train_state_from_numpy(tiny["tree"], device="cpu")
    assert isinstance(tstate, TrainState) and tstate.opt.step.dtype == torch.int32
    back = train_state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(tuple(tiny["tree"]))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
