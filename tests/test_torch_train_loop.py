"""The port's ``Trainer`` (checkpoint, crash and resume), the image of a
train state against the JAX package's, the pool's prompt release of its
arenas, and the launchers and example twins at tiny sizes on the CPU.

Twins of ``tests/test_fault_tolerance.py``'s checkpoint tests (its crash →
resume test is marked slow there; here it is fast, on the CPU): the resumed
run's parameters must equal the uninterrupted run's bit for bit (every op
of the port's CPU step is deterministic), within the reference test's
``rtol=1e-6, atol=1e-7`` at the least.  The image of a ``TrainState``
carried across by ``interop`` is ``==`` the reference's, manifest included.
"""
import gc
import sys
import threading
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import flatten_state as jax_flatten_state
from repro.configs.base import get_config as jax_get_config
from repro.core import StateImage as JaxStateImage
from repro.models.model_zoo import build as jax_build
from repro.train.trainstep import init_train_state as jax_init_train_state
from repro_torch.checkpoint.ckpt import (
    default_train_hotness,
    flatten_state,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs.base import get_config
from repro_torch.core import HierarchicalPool, Orchestrator, PoolMaster, StateImage
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.interop import train_state_from_numpy, train_state_to_numpy
from repro_torch.models import build
from repro_torch.train import LoopConfig, Trainer
from repro_torch.train.trainstep import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
TINY = get_config("qwen2.5-14b").reduced(
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=128, d_head=32)


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


def make_stack():
    pool = HierarchicalPool(8 << 20, 16 << 20, device="cpu")
    master = PoolMaster(pool)
    orch = Orchestrator("host0", pool, master.catalog)
    return pool, master, orch


def _batch(data, i):
    return {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}


@pytest.mark.parametrize("async_first", [False, True], ids=["blocking", "async"])
def test_crash_resume_reproduces_uninterrupted_run(async_first):
    """train 10 → [crash] → restore → train to 20 equals a straight 20-step
    run, bit for bit."""
    model = build(TINY, device="cpu")
    data = SyntheticLMData(DataConfig(vocab=TINY.vocab, seq_len=32, global_batch=4))
    step = make_train_step(model)
    ref = init_train_state(model, 0)
    for i in range(20):
        ref, _ = step(ref, _batch(data, i))

    pool, master, orch = make_stack()
    t1 = Trainer(model, data, master=master, orch=orch,
                 loop_cfg=LoopConfig(steps=10, ckpt_every=10, log_every=100,
                                     async_checkpoint=async_first))
    t1.run()
    assert [s["step"] for s in t1.ckpt_stats] == [10]
    t2 = Trainer(model, data, master=master, orch=orch,
                 loop_cfg=LoopConfig(steps=20, ckpt_every=0, log_every=100))
    final = t2.run(resume=True)
    assert t2.metrics_log[0]["event"] == "restored" and t2.metrics_log[0]["step"] == 10
    assert int(final.opt.step) == 20
    for a, b in zip(tree_leaves(ref), tree_leaves(final)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-7)
        assert torch.equal(a, b)


def test_restored_state_is_bit_identical_to_the_checkpointed_one():
    model = build(TINY, device="cpu")
    data = SyntheticLMData(DataConfig(vocab=TINY.vocab, seq_len=32, global_batch=4))
    pool, master, orch = make_stack()
    trainer = Trainer(model, data, master=master, orch=orch,
                      loop_cfg=LoopConfig(steps=3, ckpt_every=0, log_every=100))
    state = trainer.run()
    trainer.checkpoint(state, 3, block=True)
    restored, start, stats = trainer.try_restore(init_train_state(model, 1))
    assert start == 3 and stats["time_to_hot_s"] <= stats["time_to_full_s"]
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_state_image_is_byte_identical_to_the_references():
    """The reference's ``TrainState`` carried across by ``interop``: the
    port's ``StateImage`` of it is the reference's, manifest and bytes."""
    jm = jax_build(jax_get_config("qwen2.5-14b").reduced(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=128, d_head=32))
    jstate = jax_init_train_state(jm, jax.random.PRNGKey(0))
    jimg = JaxStateImage.build(jax_flatten_state({"params": jstate.params, "opt": jstate.opt}))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    timg = StateImage.build(flatten_state({"params": tstate.params, "opt": tstate.opt}),
                            device="cpu")
    assert timg.manifest.to_dict() == jimg.manifest.to_dict()
    np.testing.assert_array_equal(timg.buf.numpy(), np.asarray(jimg.buf).view(np.uint8))
    back = train_state_to_numpy(tstate)
    assert np.asarray(back.opt.step).dtype == np.int32


def test_hotness_split_params_hot_moments_cold():
    model = build(TINY, device="cpu")
    state = init_train_state(model, 0)
    img = StateImage.build(flatten_state({"params": state.params, "opt": state.opt}),
                           device="cpu")
    ws = set(default_train_hotness(img.manifest).tolist())
    some_param = next(e for e in img.manifest.extents if e.name.startswith("params/"))
    assert set(some_param.pages()) <= ws
    for e in img.manifest.extents:
        if e.name.startswith(("opt/m/", "opt/v/")):
            assert not (set(e.pages()) & ws), e.name
    step = next(e for e in img.manifest.extents if e.name == "opt/step")
    assert set(step.pages()) <= ws


def test_restore_missing_snapshot():
    pool, master, orch = make_stack()
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(orch, "nope", {})
    assert orch.stats["cold_starts"] == 1
    model = build(TINY, device="cpu")
    trainer = Trainer(model, SyntheticLMData(DataConfig(vocab=TINY.vocab, seq_len=16,
                                                        global_batch=2)),
                      master=master, orch=orch, loop_cfg=LoopConfig(ckpt_name="absent"))
    template = init_train_state(model, 0)
    state, start, stats = trainer.try_restore(template)
    assert state is template and start == 0 and stats is None


def test_async_checkpoint_thread_is_joined_and_copies_the_state(monkeypatch):
    """The asynchronous publish runs on a thread over a host copy taken
    before the next step updates the state in place; ``run`` joins it."""
    import repro_torch.train.loop as loop_mod

    model = build(TINY, device="cpu")
    data = SyntheticLMData(DataConfig(vocab=TINY.vocab, seq_len=16, global_batch=2))
    pool, master, orch = make_stack()
    before = set(threading.enumerate())
    started = []
    real_thread = threading.Thread

    def recording_thread(*a, **kw):
        t = real_thread(*a, **kw)
        started.append(t)
        return t

    trainer = Trainer(model, data, master=master, orch=orch,
                      loop_cfg=LoopConfig(steps=6, ckpt_every=2, log_every=1))
    monkeypatch.setattr(loop_mod.threading, "Thread", recording_thread)
    state = trainer.run()
    monkeypatch.undo()
    assert len(started) == 3 and not any(t.is_alive() for t in started)
    assert trainer._ckpt_thread is None and set(threading.enumerate()) <= before
    assert [s["step"] for s in trainer.ckpt_stats] == [2, 4, 6]
    restored, start, _ = trainer.try_restore(init_train_state(model, 1))
    assert start == 6
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(a, b)
    assert [m["step"] for m in trainer.metrics_log] == list(range(6))


@pytest.mark.parametrize("what", ["pool", "master-with-capacity", "checkpoint-and-restore"])
def test_a_dropped_pool_frees_its_arenas_without_the_cyclic_collector(what):
    """With ``gc`` disabled, the last reference going frees the tier arenas:
    the tiers hold their dedup stores and the capacity manager its master
    weakly, so no reference cycle keeps them."""
    gc.collect()
    gc.disable()
    try:
        pool = HierarchicalPool(1 << 20, 4 << 20, device="cpu")
        arenas = [weakref.ref(pool.cxl.buf), weakref.ref(pool.rdma.buf)]
        keep = [pool]
        if what != "pool":
            master = PoolMaster(pool, cxl_budget=1 << 20)
            keep.append(master)
            assert master.capacity.master is master
            assert pool.cxl.dedup_store is pool.dedup_cxl
        if what == "checkpoint-and-restore":
            orch = Orchestrator("h", pool, master.catalog)
            tree = {"params": {"w": torch.randn(300, 100)}, "opt": {"m": {"w": torch.ones(9)}}}
            save_checkpoint(master, "x", tree, 3)
            restored, _ = restore_checkpoint(orch, "x", tree)
            assert torch.equal(restored["params"]["w"], tree["params"]["w"])
            keep += [orch, restored]
        del pool, keep
        if what != "pool":
            del master
        if what == "checkpoint-and-restore":
            del orch, restored
        assert [r() is None for r in arenas] == [True, True]
    finally:
        gc.enable()


def test_tier_store_back_pointer_is_weak():
    pool = HierarchicalPool(1 << 20, 1 << 20, device="cpu")
    store = pool.dedup_rdma
    assert pool.rdma.dedup_store is store
    tier = pool.rdma
    del pool, store
    gc.collect()
    assert tier.dedup_store is None


# --------------------------------------------------------------------------
# launchers and example twins, on the CPU at tiny sizes
# --------------------------------------------------------------------------

def test_launch_train_runs_and_resumes(capsys):
    from repro_torch.launch import train

    assert train.main(["--steps", "4", "--seq", "16", "--batch", "2", "--ckpt-every", "2",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "checkpoint:" in out and "step     3" in out
    assert train.main(["--steps", "2", "--seq", "16", "--batch", "2", "--resume",
                       "--device", "cpu", "--arch", "phi4-mini-3.8b"]) == 0


def test_launch_serve_runs(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--requests", "2", "--prompt-len", "4", "--gen-tokens", "3",
                       "--max-len", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "published" in out and "warm restore" in out and "req1:" in out


def test_launchers_default_to_the_card():
    from repro_torch.launch import serve, train

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for main in (train.main, serve.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])


def _script(name):
    if str(ROOT / "scripts") not in sys.path:
        sys.path.insert(0, str(ROOT / "scripts"))
    return __import__(name)


def test_quickstart_twin_trains_restores_and_generates():
    out = _script("quickstart").run(device="cpu")
    assert out["losses"][-1] < out["losses"][0] - 0.1
    assert out["restore_stats"]["meta"]["step"] == 30
    assert [s["step"] for s in out["ckpt_stats"]] == [15, 30]
    for a, b in zip(tree_leaves(out["state"].params), tree_leaves(out["restored"]["params"])):
        assert torch.equal(a, b)
    assert out["tokens"].shape == (1, 12)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()


def test_train_e2e_twin_crashes_and_resumes(capsys):
    out = _script("train_e2e").main(["--steps", "4", "--crash-at", "2", "--device", "cpu"])
    trainer = out["trainer"]
    assert trainer.metrics_log[0] == {**trainer.metrics_log[0], "event": "restored", "step": 2}
    assert int(out["state"].opt.step) == 4
    assert "simulated crash after step 2" in capsys.readouterr().out
