"""Port parity of heat-driven re-curation: twins of the re-curation tests of
``tests/test_recuration.py`` (planning, the break-even gate, a recurated
restore, the stale abort, registry pruning, RDMA exhaustion, missing heat)
run through both packages on the same numpy-seeded image, with the same
telemetry; plans, economics, catalog states, tier bytes, free lists and
restore ledgers equal the JAX package's.  The JAX side publishes with its
fused kernel in Pallas interpret mode."""
import numpy as np
import pytest

from repro import core as ref
from repro.core.pool import AllocError as RefAllocError
from repro.kernels import make_fused_publish_fn as ref_publish_fn
from repro.serve import strategies as ref_s
from repro_torch import core as port
from repro_torch import interop
from repro_torch.core.coherence import STATE_PUBLISHED
from repro_torch.core.pool import AllocError
from repro_torch.kernels import make_fused_publish_fn
from repro_torch.serve import strategies as s
from test_torch_coherence import _plain, ref_catalog_state

PAGE = 4096


def _arrays(seed=0, hot_pages=32, cold_pages=64, zero_pages=16):
    rng = np.random.default_rng(seed)
    return {
        "params": rng.standard_normal(hot_pages * PAGE // 4).astype(np.float32),
        "runtime": rng.integers(1, 7, (cold_pages * PAGE,)).astype(np.uint8),
        "arena": np.zeros(zero_pages * PAGE, np.uint8),
    }


def _image(mod, seed=0, **kw):
    arrays = _arrays(seed, **kw)
    img = (mod.StateImage.build(arrays) if mod is ref
           else mod.StateImage.build(arrays, device="cpu"))
    rec = mod.AccessRecorder(img.manifest)
    rec.touch_array("params")
    return img, rec.working_set()


def _pod(mod, heat=None, cxl=128 << 20, rdma=512 << 20, **kw):
    if mod is ref:
        pool = ref.HierarchicalPool(cxl_capacity=cxl, rdma_capacity=rdma)
        fn = ref_publish_fn(block_pages=64, use_pallas=True, interpret=True)
    else:
        pool = port.HierarchicalPool(cxl_capacity=cxl, rdma_capacity=rdma, device="cpu")
        fn = make_fused_publish_fn()
    if heat is True:
        heat = mod.HeatRegistry(clock=pool.clock, half_life_s=1e6)
    return pool, mod.PoolMaster(pool, heat=heat, publish_fn=fn, **kw)


def _assert_pods_equal(pr, pg, mr, mg):
    assert _plain(interop.catalog_state(mg.catalog)) == ref_catalog_state(mr.catalog)
    for t in ("cxl", "rdma"):
        tr, tg = getattr(pr, t), getattr(pg, t)
        assert tr._free == tg.free_list()
        np.testing.assert_array_equal(tr.buf, tg.buf.numpy())
    assert mr._versions == mg._versions


def _host(buf) -> np.ndarray:
    return buf if isinstance(buf, np.ndarray) else buf.numpy()


def _drift(img):
    rt = img.manifest.by_name()["runtime"]
    return rt, img.manifest.by_name()["params"]


def test_plan_recuration_promotes_and_demotes():
    plans = {}
    for mod in (ref, port):
        img, ws = _image(mod)
        pool, master = _pod(mod, heat=True)
        regions = master.publish("s", img, ws)
        hm = master.heat.map_for("s", 0, regions.total_pages)
        rt, pm = _drift(img)
        drift = np.arange(rt.first_page, rt.first_page + 10)
        hm.record(mod.TouchEvent(pages=drift, kind="demand_fault"))
        hm.record(mod.TouchEvent(pages=drift, kind="demand_fault"))
        touched_hot = np.arange(pm.first_page, pm.first_page + 8)
        hm.record(mod.TouchEvent(pages=touched_hot, kind="touch"))
        hm.note_restore()
        hm.note_restore()
        plans[mod] = (mod.plan_recuration(pool, regions, hm, min_restores=2), regions,
                      drift, touched_hot)
    want, regions, drift, touched_hot = plans[ref]
    got = plans[port][0]
    assert isinstance(got, port.RecurationPlan) and got.changed
    for field in ("promote", "demote", "new_working_set"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert getattr(got, field).dtype == np.int64
    assert got.summary() == want.summary()
    assert (got.name, got.version, got.model_ordered) == ("s", 0, False)
    assert set(got.promote) == set(drift)
    assert set(touched_hot).isdisjoint(got.demote)
    assert got.demote.size == regions.n_hot - touched_hot.size
    assert got.n_hot_after == got.n_hot_before - got.demote.size + got.promote.size


def test_plan_model_ordering_and_max_promote_match_reference():
    """With a fitted first-touch model the promote set is in predicted order,
    cut to ``max_promote``."""
    plans = {}
    for mod in (ref, port):
        img, ws = _image(mod)
        pool, master = _pod(mod, heat=True)
        regions = master.publish("s", img, ws)
        hm = master.heat.map_for("s", 0, regions.total_pages)
        rt, _pm = _drift(img)
        seq = rt.first_page + np.array([40, 41, 3, 4, 5, 20, 21, 60, 61, 62])
        for stream in (1, 2):
            hm.record(mod.TouchEvent(pages=seq, kind="demand_fault", stream=stream))
        hm.note_restore()
        model = mod.fit_prefetch_model(hm)
        plans[mod] = mod.plan_recuration(pool, regions, hm, min_restores=5, model=model,
                                         max_promote=6)
    got, want = plans[port], plans[ref]
    assert got.model_ordered and want.model_ordered
    np.testing.assert_array_equal(got.promote, want.promote)
    assert got.promote.size == 6 and got.demote.size == 0
    assert got.summary() == want.summary()


def test_recuration_economics_break_even():
    side = {}
    for mod, econ_fn in ((ref, ref_s.recuration_economics), (port, s.recuration_economics)):
        img, ws = _image(mod)
        pool, master = _pod(mod, heat=True)
        regions = master.publish("s", img, ws)
        hm = master.heat.map_for("s", 0, regions.total_pages)
        rt, _pm = _drift(img)
        for _ in range(2):
            hm.record(mod.TouchEvent(pages=np.arange(rt.first_page, rt.first_page + 10),
                                     kind="demand_fault"))
        hm.note_restore()
        plan = mod.plan_recuration(pool, regions, hm, min_restores=1)
        cheap = econ_fn(regions, plan, expected_restores=1)
        rich = econ_fn(regions, plan, expected_restores=100000)
        assert not cheap["worthwhile"] and rich["worthwhile"]
        assert rich["benefit_s"] > cheap["benefit_s"]
        assert rich["cost_s"] == pytest.approx(cheap["cost_s"])
        assert master.recurate("s", expected_restores=1) is None
        new = master.recurate("s", expected_restores=100000)
        assert new is not None and new.version == 1
        side[mod] = (pool, master, cheap, rich, new)
    (pr, mr, cheap_r, rich_r, new_r), (pg, mg, cheap_g, rich_g, new_g) = side[ref], side[port]
    assert (cheap_g, rich_g) == (cheap_r, rich_r)
    assert new_g.to_dict() == new_r.to_dict()
    _assert_pods_equal(pr, pg, mr, mg)


def test_recuration_benefit_monotone():
    assert s.recuration_benefit_s(0, 0, 100) == 0.0
    assert s.recuration_benefit_s(10, 0, 100) > s.recuration_benefit_s(5, 0, 100)
    assert s.recuration_benefit_s(10, 5, 100) > s.recuration_benefit_s(10, 0, 100)
    costs = []
    for mod, fn in ((ref, ref_s.recuration_cost_s), (port, s.recuration_cost_s)):
        img, ws = _image(mod)
        _pool, master = _pod(mod)
        costs.append(fn(master.publish("s", img, ws)))
    assert costs[1] == costs[0] > 0.0


def test_recurated_restore_bit_identical_and_version_bumped():
    side = {}
    for mod in (ref, port):
        img, ws = _image(mod)
        pool, master = _pod(mod, heat=True)
        master.publish("s", img, ws)
        orch = mod.Orchestrator("h0", pool, master.catalog, heat=master.heat)
        rt, _pm = _drift(img)
        drift = np.arange(rt.first_page, rt.first_page + 12)
        ledgers = []
        for _ in range(2):
            ri = orch.restore("s")
            ri.engine.touch_pages(drift)
            ledgers.append(dict(ri.ledger.seconds))
            ri.shutdown()
        publishes = []
        fn = master.publish_fn
        master.publish_fn = lambda *a, **k: publishes.append(1) or fn(*a, **k)
        new = master.recurate("s", expected_restores=100000)
        assert new is not None and new.version == 1 and publishes == [1]
        entry = master.catalog.find("s")
        assert entry.state.load() == STATE_PUBLISHED and entry.version == 1
        ri = orch.restore("s")
        assert ri.borrow.version == 1
        assert bool(ri.instance.present[drift].all())     # pre-installed from CXL now
        f0 = ri.instance.stats["fault_rdma"]
        ri.engine.touch_pages(drift)
        assert ri.instance.stats["fault_rdma"] == f0
        ri.engine.install_all_sync()
        np.testing.assert_array_equal(_host(ri.instance.image.buf), _host(img.buf))
        ledgers.append(dict(ri.ledger.seconds))
        stats = dict(ri.instance.stats)
        ri.shutdown()
        orch.close()
        side[mod] = (pool, master, ledgers, stats, new)
    (pr, mr, led_r, st_r, new_r), (pg, mg, led_g, st_g, new_g) = side[ref], side[port]
    assert led_g == led_r
    assert st_g == st_r
    assert new_g.to_dict() == new_r.to_dict()
    _assert_pods_equal(pr, pg, mr, mg)


def test_recurate_aborts_stale_when_update_races_in():
    side = {}
    for mod in (ref, port):
        img, ws = _image(mod)
        pool, master = _pod(mod, heat=True)
        regions = master.publish("s", img, ws)
        hm = master.heat.map_for("s", 0, regions.total_pages)
        rt, _pm = _drift(img)
        for _ in range(2):
            hm.record(mod.TouchEvent(pages=np.arange(rt.first_page, rt.first_page + 8),
                                     kind="demand_fault"))
        hm.note_restore()
        gen = master.recurate_steps("s", force=True)
        labels = []
        label = None
        while label != "reconstructed":
            label, _val = next(gen)
            labels.append(label)
        img2, ws2 = _image(mod, 7)
        master.publish("s", img2, ws2)        # a legitimate update races in
        tail = [lbl for lbl, _v in gen]
        assert labels == ["planned", "reconstructed"] and tail == ["stale"]
        entry = master.catalog.find("s")
        assert entry.version == 1 and entry.state.load() == STATE_PUBLISHED
        orch = mod.Orchestrator("h0", pool, master.catalog)
        ri = orch.restore("s")
        ri.engine.install_all_sync()
        np.testing.assert_array_equal(_host(ri.instance.image.buf), _host(img2.buf))
        ri.shutdown()
        orch.close()
        side[mod] = (pool, master)
    _assert_pods_equal(side[ref][0], side[port][0], side[ref][1], side[port][1])


def test_heat_registry_pruned_on_republish():
    for mod in (ref, port):
        img, ws = _image(mod)
        pool, master = _pod(mod, heat=True)
        regions = master.publish("s", img, ws)
        for v in range(3):
            master.heat.map_for("s", v, regions.total_pages)
        master.publish("s", img, ws)       # -> version 1, prunes < 0 (none)
        master.publish("s", img, ws)       # -> version 2, prunes < 1
        assert master.heat.find("s", 0) is None
        assert master.heat.find("s", 1) is not None


def test_rdma_exhaustion_is_not_degraded():
    for mod, err in ((ref, RefAllocError), (port, AllocError)):
        img, ws = _image(mod, cold_pages=64)
        _pool, master = _pod(mod, rdma=8 * PAGE, cxl_budget=1 << 30)
        with pytest.raises(err):
            master.publish("s", img, ws)
        assert master.capacity.budget.stats["degraded"] == 0


def test_recurate_missing_or_no_heat_returns_none():
    for mod in (ref, port):
        img, ws = _image(mod)
        _pool, master = _pod(mod)
        master.publish("s", img, ws)
        assert master.recurate("nope") is None        # unknown name
        assert master.recurate("s") is None           # no heat recorded
        assert master.catalog.find("s").refcount.load() == 0
        assert [lbl for lbl, _v in master.recurate_steps("nope")] == ["missing"]
