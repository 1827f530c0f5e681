"""The port's ``serve/coldstart``: twins of ``tests/test_coldstart_pool.py``
(``Skeleton.created_at`` from the injected clock, a full pool that parks
instead of polling, a claim that wakes the replenisher, a prompt close, a
virtual clock that does not move), then ``restore_server`` + ``generate`` on
reduced phi4-mini (float32 compute) through both packages: the same
snapshot published by ``save_checkpoint``, warm-restored into a claimed
skeleton, serving the same tokens as the JAX package's and as an instance
built on the original parameters."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref
from repro.checkpoint.ckpt import save_checkpoint as ref_save
from repro.configs.base import get_config as jax_get_config
from repro.models.model_zoo import build as jax_build
from repro.serve.coldstart import SkeletonPool as RefSkeletonPool
from repro.serve.coldstart import restore_server as ref_restore_server
from repro_torch import core as port
from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.configs.base import get_config
from repro_torch.core.clock import RealClock
from repro_torch.interop import params_from_numpy
from repro_torch.serve import new_instance
from repro_torch.serve.coldstart import Skeleton, SkeletonPool, restore_server
from repro_torch.sim.clock import VirtualClock

TINY = get_config("qwen2.5-14b").reduced(
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=128,
    d_head=32, name="qwen2.5-14b-coldstart-port-tiny")


class CountingClock(RealClock):
    """RealClock that counts blocking-primitive calls: a busy-polling loop
    shows dozens of waits per second, a parked one shows ~1 total."""

    def __init__(self):
        self.wait_calls = 0

    def cv_wait_for(self, cv, predicate, timeout_s):
        self.wait_calls += 1
        return super().cv_wait_for(cv, predicate, timeout_s)

    def wait_event(self, event, timeout_s):
        self.wait_calls += 1
        return super().wait_event(event, timeout_s)


def _pool(**kw):
    return SkeletonPool(TINY, batch=1, max_len=32, target_size=1, device="cpu", **kw)


def test_created_at_uses_injected_clock():
    clk = VirtualClock(start=100.0)
    sp = _pool(background=False, clock=clk)
    sk = sp.claim()                      # pre-filled at construction
    assert isinstance(sk, Skeleton) and sk.created_at == 100.0
    assert sk.caches["k"].device.type == "cpu" and sk.model.device.type == "cpu"
    clk.advance(5.0)
    sk2 = sp.claim()                     # queue empty -> built on demand
    assert sk2.created_at == 105.0
    assert sp.stats == {"claimed": 2, "created_on_demand": 1, "replenished": 0}
    sp.close()


def test_full_pool_does_not_spin():
    clk = CountingClock()
    sp = _pool(background=True, clock=clk)
    try:
        deadline = time.monotonic() + 2.0
        while clk.wait_calls < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        calls_before = clk.wait_calls
        time.sleep(0.25)                 # 100 Hz polling would add ~25 calls
        assert clk.wait_calls - calls_before <= 1
        assert clk.wait_calls <= 2
        assert sp.stats["replenished"] == 0
    finally:
        sp.close()


def test_claim_wakes_replenisher():
    clk = CountingClock()
    sp = _pool(background=True, clock=clk)
    try:
        sp.claim()
        deadline = time.monotonic() + 10.0
        while sp.stats["replenished"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sp.stats["replenished"] == 1
        assert sp._q.qsize() == 1
    finally:
        sp.close()
    assert not sp._t.is_alive(), "close() must stop the replenish thread"


def test_close_stops_parked_thread_promptly():
    before = set(threading.enumerate())
    sp = _pool(background=True)
    t0 = time.monotonic()
    sp.close()
    assert time.monotonic() - t0 < 5.0
    assert not sp._t.is_alive()
    assert not (set(threading.enumerate()) - before)


def test_virtual_clock_does_not_advance_through_the_pool():
    """A pool on a virtual clock stamps, claims and closes without moving
    simulated time: nothing in it sleeps or waits on the clock."""
    clk = VirtualClock(start=7.0)
    sp = _pool(background=False, clock=clk)
    sp.claim()
    sp.claim()
    sp.close()
    assert clk.monotonic() == 7.0


@pytest.mark.parametrize("prefetch_cold", [False, True])
def test_restore_server_serves_the_reference_tokens(prefetch_cold, monkeypatch):
    kw = dict(compute_dtype="float32", name="phi4-mini-3.8b-coldstart-port-parity")
    jcfg, tcfg = jax_get_config("phi4-mini-3.8b").reduced(**kw), \
        get_config("phi4-mini-3.8b").reduced(**kw)
    tree = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(3)))
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    if prefetch_cold:       # the touch loop rides the prefetcher, in both packages
        for mod in (ref, port):
            access = mod.RestoreEngine.access

            def after_prefetch(self, page, timeout_s=30.0, _access=access):
                assert self.wait_prefetch_idle(60.0)
                return _access(self, page, timeout_s)

            monkeypatch.setattr(mod.RestoreEngine, "access", after_prefetch)

    pool_r = ref.HierarchicalPool(16 << 20, 32 << 20)
    master_r = ref.PoolMaster(pool_r)
    ref_save(master_r, "model", {"params": jax.tree.map(jnp.asarray, tree)}, step=0)
    orch_r = ref.Orchestrator("serve-host", pool_r, master_r.catalog,
                              prefetch_cold=prefetch_cold)
    sp_r = RefSkeletonPool(jcfg, batch=2, max_len=24, target_size=1, background=False)
    out_r = ref_restore_server(orch_r, "model", sp_r.claim(), jax.tree.map(jnp.asarray, tree))
    want = out_r["instance"].generate(jnp.asarray(prompt), 8)
    sp_r.close()
    orch_r.close()

    params = params_from_numpy(tree, device="cpu")
    pool = port.HierarchicalPool(16 << 20, 32 << 20, device="cpu")
    master = port.PoolMaster(pool)
    save_checkpoint(master, "model", {"params": params}, step=0)
    orch = port.Orchestrator("serve-host", pool, master.catalog, prefetch_cold=prefetch_cold)
    sp = SkeletonPool(tcfg, batch=2, max_len=24, target_size=1, background=True,
                      device="cpu")
    out = restore_server(orch, "model", sp.claim(), params)
    got = out["instance"].generate(prompt, 8)
    sp.close()
    orch.close()
    assert not sp._t.is_alive()

    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, new_instance(tcfg, params, 2, 24, device="cpu").generate(prompt, 8))
    for name, t in out["state"]["params"]["layers"]["mlp"].items():
        assert torch.equal(t, params["layers"]["mlp"][name])
    st, st_r = out["stats"], out_r["stats"]
    assert st["modeled"] == st_r["modeled"]
    assert st["instance"] == st_r["instance"]
    assert st["meta"] == st_r["meta"] == {"step": 0}
    assert master.delete("model") and pool.cxl.bytes_in_use == pool.rdma.bytes_in_use == 0
