"""Port parity of the pod control plane: ``PoolMaster`` publishes, updates,
deletes and demotes, ``Orchestrator`` restores, and both packages given the
same numpy-seeded images and the same operation sequence end with equal
catalogs, region records, tier bytes, free lists, restored images and
ledgers.  A pod the JAX package published is carried over by ``interop``
and restored by the port's ``Orchestrator``; an owner update during a
borrowed restore drains until the borrow is released, so the port's batched
walk never meets a rewritten arena."""
import threading
import time

import numpy as np
import pytest
import torch

from repro import core as ref
from repro.core.profiler import AccessRecorder
from repro.kernels import make_fused_publish_fn as ref_publish_fn
from repro_torch import core as port
from repro_torch import interop
from repro_torch.core import STATE_TOMBSTONE
from repro_torch.kernels import FusedScatter, fused_publish, make_fused_publish_fn
from test_torch_coherence import _plain, ref_catalog_state

PAGE = 4096


def make_arrays(seed, hot_pages=48, cold_pages=96, zero_pages=64):
    rng = np.random.default_rng(seed)
    arrays = {
        "params": rng.standard_normal(hot_pages * PAGE // 4).astype(np.float32),
        "runtime": rng.integers(1, 7, (cold_pages * PAGE,)).astype(np.uint8),
        "arena": np.zeros(zero_pages * PAGE, np.uint8),
    }
    rec = AccessRecorder(ref.StateImage.build(arrays).manifest)
    rec.touch_array("params")
    rt = rec.manifest.by_name()["runtime"]
    rec.touch_pages(range(rt.first_page + 7, rt.first_page + 11))
    return arrays, rec.working_set()


def _image(mod, arrays):
    return mod.StateImage.build(arrays) if mod is ref else mod.StateImage.build(arrays, device="cpu")


def _pool(mod, cxl=16 << 20, rdma=32 << 20):
    if mod is ref:
        return ref.HierarchicalPool(cxl, rdma)
    return port.HierarchicalPool(cxl, rdma, device="cpu")


def _publish_fn(mod):
    if mod is ref:
        return ref_publish_fn(block_pages=64, use_pallas=True, interpret=True)
    return make_fused_publish_fn()


def _assert_pods_equal(pr, pg, mr, mg):
    assert _plain(interop.catalog_state(mg.catalog)) == ref_catalog_state(mr.catalog)
    for er, eg in zip(mr.catalog.entries, mg.catalog.entries):
        cs_r = getattr(er.regions, "page_checksums", None)
        cs_g = getattr(eg.regions, "page_checksums", None)
        assert (cs_r is None) == (cs_g is None)
        if cs_r is not None:
            np.testing.assert_array_equal(cs_r, cs_g.numpy().view(np.uint32))
    for t in ("cxl", "rdma"):
        tr, tg = getattr(pr, t), getattr(pg, t)
        assert tr._free == tg.free_list()
        assert tr.bytes_in_use == tg.bytes_in_use
        np.testing.assert_array_equal(tr.buf, tg.buf.numpy())
    assert mr._versions == mg._versions
    assert mr._pending_reclaim == [] and mg._pending_reclaim == []


def _restore_all(orch, name):
    ri = orch.restore(name)
    ri.engine.install_all_sync()
    return ri


@pytest.mark.parametrize("use_node_server", [True, False])
def test_pod_lifecycle_same_in_both_packages(use_node_server):
    """publish x2 → restore each → update one → delete the other → gc,
    through both packages step by step."""
    arrays = [make_arrays(s) for s in (1, 2, 3)]
    side = {}
    for mod in (ref, port):
        pool = _pool(mod)
        master = mod.PoolMaster(pool, publish_fn=_publish_fn(mod))
        orch = mod.Orchestrator("h0", pool, master.catalog, use_node_server=use_node_server)
        side[mod] = (pool, master, orch)
    (pr, mr, orr), (pg, mg, org) = side[ref], side[port]

    for name, (a, ws) in zip(("a", "b"), arrays):
        reg_r = mr.publish(name, _image(ref, a), ws, metadata={"n": name})
        reg_g = mg.publish(name, _image(port, a), ws, metadata={"n": name})
        assert reg_r.to_dict() == reg_g.to_dict()
    _assert_pods_equal(pr, pg, mr, mg)

    for name, (a, _ws) in zip(("a", "b"), arrays):
        ri_r, ri_g = _restore_all(orr, name), _restore_all(org, name)
        np.testing.assert_array_equal(ri_g.instance.image.buf.numpy(), ri_r.instance.image.buf)
        np.testing.assert_array_equal(ri_g.instance.image.buf.numpy(), _image(ref, a).buf)
        assert ri_g.ledger.seconds == ri_r.ledger.seconds
        assert ri_g.instance.stats == ri_r.instance.stats
        assert ri_g.borrow.version == ri_r.borrow.version == 0
        ri_r.shutdown()
        ri_g.shutdown()
    assert orr.stats == org.stats == {"warm_restores": 2, "cold_starts": 0}

    a2, ws2 = arrays[2]
    assert mr.publish("a", _image(ref, a2), ws2).version == 1
    assert mg.publish("a", _image(port, a2), ws2).version == 1
    _assert_pods_equal(pr, pg, mr, mg)
    ri_g = _restore_all(org, "a")
    assert torch.equal(ri_g.instance.image.buf, _image(port, a2).buf)
    ri_g.shutdown()

    assert mr.delete("b") and mg.delete("b")
    assert mr.gc() == mg.gc() == 0                # delete() already reclaimed
    _assert_pods_equal(pr, pg, mr, mg)
    assert org.restore("b") is None and orr.restore("b") is None
    assert org.stats["cold_starts"] == orr.stats["cold_starts"] == 1
    assert mg.delete("a") and mr.delete("a")
    _assert_pods_equal(pr, pg, mr, mg)
    assert pg.cxl.bytes_in_use == pg.rdma.bytes_in_use == 0
    assert pg.cxl.free_list() == [(0, pg.cxl.capacity)]
    orr.close()
    org.close()


def test_jax_published_pod_restored_by_port_orchestrator():
    """The JAX PoolMaster publishes a pod (fused publish, Pallas interpret
    mode); its tier arenas, free lists and catalog cross as plain data; the
    port's Orchestrator restores every snapshot bit-identically and verified,
    and the port's master deletes them back to an empty pool."""
    pool_r = _pool(ref)
    master_r = ref.PoolMaster(pool_r, publish_fn=_publish_fn(ref))
    images = {}
    for name, seed in (("x", 4), ("y", 5)):
        a, ws = make_arrays(seed)
        images[name] = a
        master_r.publish(name, _image(ref, a), ws)
    a, ws = make_arrays(6)
    images["x"] = a
    master_r.publish("x", _image(ref, a), ws)                 # x is at version 1

    pool_g = interop.pool_from_numpy(pool_r.cxl.buf, pool_r.rdma.buf,
                                     {"cxl": pool_r.cxl._free, "rdma": pool_r.rdma._free},
                                     device="cpu")
    state = ref_catalog_state(master_r.catalog)
    for e, er in zip(state["entries"], [e for e in master_r.catalog.entries if e.name]):
        e["regions"] = (e["regions"], er.regions.page_checksums)
    catalog = interop.catalog_from_state(state)
    master_g = port.PoolMaster(pool_g, catalog)
    master_g._versions = {e.name: e.version for e in catalog.entries if e.name}
    orch = port.Orchestrator("h1", pool_g, catalog)
    for name, a in images.items():
        scatter = FusedScatter()
        orch.scatter_fn = scatter
        ri = _restore_all(orch, name)
        assert torch.equal(ri.instance.image.buf, _image(port, a).buf)
        r = ri.borrow.regions
        assert scatter.stats["pages_verified"] == r.n_hot + r.n_cold
        assert ri.borrow.version == {"x": 1, "y": 0}[name]
        ri.shutdown()
    orch.close()
    for name in images:
        assert master_g.delete(name) and master_r.delete(name)
    _assert_pods_equal(pool_r, pool_g, master_r, master_g)
    assert pool_g.cxl.bytes_in_use == pool_g.rdma.bytes_in_use == 0


@pytest.mark.parametrize("use_node_server", [True, False])
def test_update_during_borrowed_restore_drains_until_release(use_node_server):
    """An owner update that lands while a restore holds its borrow
    tombstones the entry and waits: the old regions are neither freed nor
    rewritten until ``shutdown``, so the restore's batched, verified walks
    run to the end on unchanged bytes (no mismatch at the flush), and the
    update then publishes version 1."""
    pool = port.HierarchicalPool(8 << 20, 16 << 20, device="cpu")
    master = port.PoolMaster(pool, publish_fn=make_fused_publish_fn())
    (a0, ws0), (a1, ws1) = make_arrays(7), make_arrays(8)
    img0, img1 = _image(port, a0), _image(port, a1)
    master.publish("s", img0, ws0)
    orch = port.Orchestrator("h0", pool, master.catalog, scatter_fn=FusedScatter(),
                             use_node_server=use_node_server)
    ri = orch.restore("s", pre_install=False)
    entry = master.catalog.find("s")
    old, in_use = entry.regions, (pool.cxl.bytes_in_use, pool.rdma.bytes_in_use)
    done = threading.Event()

    def update():
        master.publish("s", img1, ws1)
        done.set()

    t = threading.Thread(target=update, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while entry.state.load() != STATE_TOMBSTONE:
        assert time.monotonic() < deadline, "update never tombstoned the entry"
        time.sleep(0.001)
    assert orch.restore("s") is None                # new borrows cold-start meanwhile
    ri.engine.pre_install_hot()
    ri.engine.install_all_sync()
    assert ri.engine.walk_routes["batched"] == 2
    assert torch.equal(ri.instance.image.buf, img0.buf)
    assert not done.is_set()                        # still draining
    assert entry.regions is old and entry.refcount.load() == 1
    assert (pool.cxl.bytes_in_use, pool.rdma.bytes_in_use) == in_use
    ri.shutdown()
    t.join(timeout=10)
    assert not t.is_alive() and done.is_set()
    ri2 = orch.restore("s")
    ri2.engine.install_all_sync()
    assert ri2.borrow.version == 1
    assert torch.equal(ri2.instance.image.buf, img1.buf)
    ri2.shutdown()
    orch.close()


def test_capacity_demotion_same_as_reference():
    """A CXL budget of 2.5 snapshots: the clock hand demotes the oldest
    snapshots to all-cold in both packages alike, and every snapshot still
    restores bit-identically on the port."""
    arrays = [make_arrays(10 + i) for i in range(4)]
    probe = port.PoolMaster(_pool(port)).publish("probe", _image(port, arrays[0][0]),
                                                 arrays[0][1])
    budget = int(2.5 * probe.cxl_size)
    pools = {mod: _pool(mod) for mod in (ref, port)}
    masters = {mod: mod.PoolMaster(pools[mod], cxl_budget=budget) for mod in (ref, port)}
    for i, (a, ws) in enumerate(arrays):
        for mod in (ref, port):
            masters[mod].publish(f"s{i}", _image(mod, a), ws)
        _assert_pods_equal(pools[ref], pools[port], masters[ref], masters[port])
    rep_r, rep_g = masters[ref].capacity.report(), masters[port].capacity.report()
    assert rep_r == rep_g and rep_g["demotions"] >= 1
    assert rep_g["in_use"] <= rep_g["budget_bytes"]
    demoted = [e.name for e in masters[port].catalog.entries
               if e.regions is not None and e.regions.n_hot == 0]
    assert "s0" in demoted
    orch = port.Orchestrator("h0", pools[port], masters[port].catalog)
    for i, (a, _ws) in enumerate(arrays):
        ri = _restore_all(orch, f"s{i}")
        assert torch.equal(ri.instance.image.buf, _image(port, a).buf)
        ri.shutdown()
    orch.close()


def test_evict_for_ranks_by_borrow_counter():
    a, ws = make_arrays(20)
    masters = {}
    for mod in (ref, port):
        master = mod.PoolMaster(_pool(mod))
        for name in ("a", "b", "c"):
            master.publish(name, _image(mod, a), ws)
        for _ in range(5):
            master.catalog.borrow("a").release()
        master.catalog.borrow("b").release()
        assert master.evict_for(1) == ["c"]
        masters[mod] = master
    assert masters[ref].collect_borrow_counters() == masters[port].collect_borrow_counters()
    assert masters[port].capacity_report() == masters[ref].capacity_report()


def test_publish_counts_one_fused_launch_per_build_on_cuda_only():
    """On CPU pools the master's publish_fn runs the plain sweep: no launch
    is counted; compress_cold passes through to build_snapshot's A4d error."""
    before = fused_publish.launches
    master = port.PoolMaster(_pool(port), publish_fn=make_fused_publish_fn())
    a, ws = make_arrays(21)
    master.publish("s", _image(port, a), ws)
    assert fused_publish.launches == before
    with pytest.raises(NotImplementedError, match="A4d"):
        master.publish("t", _image(port, a), ws, compress_cold=True)
    assert master.catalog.find("t") is None and master._busy_names == set()
