"""Port twins of the host-wide page-server tests (``core/nodeserver.py``) on
CPU pools: hot-chunk fan-out (one read, k bit-identical scatters), the solo
bypass, the late joiner, demand fan-out, demand over prefetch, DRR fairness,
executed modeled time against the reference's analytic model within the
reference test's own 15%, and stop draining buffers.  Then the deterministic
paths through both packages, whose ledgers must be ``==`` key by key: a
solo restore, and a fan-out group whose pre-installs run in a fixed order."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro import core as ref
from repro.core.profiler import AccessRecorder
from repro.serve.strategies import modeled_concurrent_restore_s
from repro_torch import core as port
from repro_torch.core import (
    HeatRegistry,
    HierarchicalPool,
    LayoutOrderPolicy,
    NodePageServer,
    Orchestrator,
    PoolMaster,
    RestoreEngine,
    StateImage,
    TimeLedger,
)
from repro_torch.core.pagestore import PAGE_SIZE
from repro_torch.core.serving import AsyncRDMAEngine
from repro_torch.kernels import FusedScatter, make_fused_publish_fn


def make_arrays(seed=0, hot_pages=128, cold_pages=384, zero_pages=512):
    """The reference test's image: random params (the working set), a
    runtime segment of small non-zero bytes with a few touched pairs of
    pages, a zero arena."""
    rng = np.random.default_rng(seed)
    arrays = {
        "params": rng.standard_normal(hot_pages * PAGE_SIZE // 4).astype(np.float32),
        "runtime": rng.integers(1, 7, (cold_pages * PAGE_SIZE,)).astype(np.uint8),
        "arena": np.zeros(zero_pages * PAGE_SIZE, np.uint8),
    }
    rec = AccessRecorder(ref.StateImage.build(arrays).manifest)
    rec.touch_array("params")
    rt = rec.manifest.by_name()["runtime"]
    for s in range(5, cold_pages - 4, max(8, cold_pages // 12)):
        rec.touch_pages(range(rt.first_page + s, rt.first_page + s + 2))
    return arrays, rec.working_set()


def make_image(seed=0, **kw):
    arrays, ws = make_arrays(seed, **kw)
    return StateImage.build(arrays, device="cpu"), ws


def make_stack(images, names=None, publish_fn=None):
    pool = HierarchicalPool(256 << 20, 512 << 20, device="cpu")
    master = PoolMaster(pool, publish_fn=publish_fn)
    names = names or [f"s{i}" for i in range(len(images))]
    for name, (img, ws) in zip(names, images):
        master.publish(name, img, ws)
    return pool, master, names


def drive_full_restore(ris, policy=None):
    """Concurrently run each restore to completion: hot pre-install + zero
    ranges + cold extent prefetch (the benchmark flow)."""
    errs = []
    policy = policy or LayoutOrderPolicy()

    def drive(ri):
        try:
            ri.engine.pre_install_hot()
            ri.engine.install_zero_runs()
            ri.engine.start_prefetcher(policy=policy)
            assert ri.engine.wait_prefetch_idle(60.0)
        except Exception as exc:            # pragma: no cover
            errs.append(exc)

    threads = [threading.Thread(target=drive, args=(ri,)) for ri in ris]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs


class TestHotChunkFanout:
    def test_one_read_k_scatters_bit_identical(self):
        k = 4
        img, ws = make_image(seed=1)
        pool, master, names = make_stack([(img, ws)], publish_fn=make_fused_publish_fn())
        server = NodePageServer("h0", pool)
        orch = Orchestrator("h0", pool, master.catalog, node_server=server,
                            scatter_fn=FusedScatter())
        ris = [orch.restore(names[0], pre_install=False, prefetch_cold=False)
               for _ in range(k)]
        assert all(ri is not None for ri in ris)
        drive_full_restore(ris)

        for ri in ris:
            assert ri.instance.present.all()
            assert torch.equal(ri.instance.image.buf, img.buf)
            assert ri.engine.prefetch_stats["pages_installed"] > 0
            # the batched walk queued rows of the cached chunk tensors
            assert ri.engine.walk_routes["batched"] == 1
        reader = ris[0].engine.reader
        r = reader.regions
        assert orch.scatter_fn.stats["pages_verified"] == k * (r.n_hot + r.n_cold)
        n_hot = int(reader.hot_page_indices().size)
        n_chunks = -(-n_hot // RestoreEngine.HOT_CHUNK_PAGES)
        assert server.chunks.stats["reads"] == n_chunks
        assert server.chunks.stats["fanout_hits"] == (k - 1) * n_chunks
        assert server.stats["fanout_installs"] > 0

        # the CXL link carried the hot bytes ONCE; each session still read
        # its own machine state + offset array
        per_session_index = r.ms_size + r.total_pages * 8
        total_read = sum(ri.engine.reader.view.stats["bytes_read"] for ri in ris)
        assert total_read == k * per_session_index + n_hot * PAGE_SIZE
        for ri in ris:
            assert ri.ledger.seconds.get("cxl_read", 0.0) > 0.0
        for ri in ris:
            ri.shutdown()
        assert server.chunks.drop_group((names[0], r.version)) == 0
        orch.close()
        server.close()

    def test_solo_restores_bypass_cache_and_stay_exact(self):
        img, ws = make_image(seed=2)
        pool, master, names = make_stack([(img, ws)])
        server = NodePageServer("h0", pool)
        orch = Orchestrator("h0", pool, master.catalog, node_server=server)
        ri1 = orch.restore(names[0], pre_install=True, prefetch_cold=False)
        assert server.chunks.stats["reads"] == 0
        assert server.chunks.stats["fanout_hits"] == 0
        ri1.shutdown()
        ri2 = orch.restore(names[0], pre_install=True, prefetch_cold=False)
        ri2.engine.install_all_sync()
        assert torch.equal(ri2.instance.image.buf, img.buf)
        ri2.shutdown()
        server.close()

    def test_late_joiner_gets_cold_pages(self):
        img, ws = make_image(seed=12)
        pool, master, names = make_stack([(img, ws)])
        server = NodePageServer("h0", pool)
        orch = Orchestrator("h0", pool, master.catalog, node_server=server)
        ri_a = orch.restore(names[0], pre_install=False, prefetch_cold=True)
        assert ri_a.engine.wait_prefetch_idle(60)
        ri_b = orch.restore(names[0], pre_install=False, prefetch_cold=True)
        assert ri_b.engine.wait_prefetch_idle(60)
        cold = ri_b.engine.reader.cold_page_indices()
        assert ri_b.instance.present[cold].all()
        ri_b.engine.pre_install_hot()
        ri_b.engine.install_zero_runs()
        assert torch.equal(ri_b.instance.image.buf, img.buf)
        ri_a.shutdown()
        ri_b.shutdown()
        server.close()

    def test_demand_fanout_one_read_credits_every_session(self):
        img, ws = make_image(seed=21)
        pool, master, names = make_stack([(img, ws)])
        heat = HeatRegistry(clock=pool.clock, half_life_s=1e6)
        server = NodePageServer("h0", pool, heat=heat)
        orch = Orchestrator("h0", pool, master.catalog, node_server=server)
        ri_a = orch.restore(names[0], pre_install=False, prefetch_cold=False)
        ri_b = orch.restore(names[0], pre_install=False, prefetch_cold=False)
        # park the shared engine so A's read is still queued when B faults
        server.engine._stop.set()
        server.engine._worker.join(timeout=10)
        assert not server.engine._worker.is_alive()

        page = int(ri_a.engine.reader.cold_page_indices()[0])
        ri_a.engine.handle_fault(page)      # posts the one physical read
        ri_b.engine.handle_fault(page)      # covered → prefetch_hit, no post
        assert server.stats["demand_reads"] == 1

        server.engine.start()               # resume; completion fans out
        assert ri_a.instance.wait_present(page, 30.0)
        assert ri_b.instance.wait_present(page, 30.0)
        # the worker counts the fan-out after its last install: wait for it
        deadline = time.monotonic() + 30.0
        while not server.stats["demand_fanout_installs"] and time.monotonic() < deadline:
            time.sleep(0.001)
        assert server.stats["demand_reads"] == 1
        assert server.stats["demand_fanout_installs"] >= 1
        hm = heat.find(names[0], 0)
        assert hm.stats["prefetch_hits"] >= 1
        assert hm.stats["demand_faults"] == 1
        want = img.buf[page * PAGE_SIZE:(page + 1) * PAGE_SIZE]
        for ri in (ri_a, ri_b):
            got = ri.instance.image.buf[page * PAGE_SIZE:(page + 1) * PAGE_SIZE]
            assert torch.equal(got, want)
        ri_a.shutdown()
        ri_b.shutdown()
        server.close()


class TestDemandOverPrefetchPriority:
    def test_urgent_overtakes_queued_prefetch_across_instances(self):
        pool = HierarchicalPool(8 << 20, 8 << 20, device="cpu")
        eng = AsyncRDMAEngine(pool.rdma, TimeLedger(), start=False)
        for i in range(6):
            eng.submit_read(i * PAGE_SIZE, PAGE_SIZE,
                            torch.empty(PAGE_SIZE, dtype=torch.uint8),
                            ("prefetch", "instA", i), urgent=False)
        for j in range(2):
            eng.submit_read(j * PAGE_SIZE, PAGE_SIZE,
                            torch.empty(PAGE_SIZE, dtype=torch.uint8),
                            ("demand", "instB", j), urgent=True)
        eng.start()
        try:
            order = []
            while len(order) < 8:
                item = eng.poll_completion(block=True, timeout_s=1.0)
                assert item is not None
                order.append(item[1])
            assert [t[0] for t in order[:2]] == ["demand", "demand"]
            assert eng.stats["urgent_reads"] == 2
        finally:
            eng.close()

    def test_server_demand_faults_are_urgent(self):
        imgs = [make_image(seed=3), make_image(seed=4)]
        pool, master, names = make_stack(imgs)
        server = NodePageServer("h0", pool)
        orch = Orchestrator("h0", pool, master.catalog, node_server=server)
        ri_a = orch.restore(names[0], pre_install=False, prefetch_cold=True)
        ri_b = orch.restore(names[1], pre_install=False, prefetch_cold=False)
        cold_b = ri_b.engine.reader.cold_page_indices()[:16]
        for p in cold_b:
            ri_b.engine.access(int(p), timeout_s=30)
        assert server.stats["demand_reads"] >= cold_b.size
        assert server.engine.stats["urgent_reads"] >= cold_b.size
        assert ri_a.engine.wait_prefetch_idle(60)
        for p in cold_b:
            lo = int(p) * PAGE_SIZE
            assert torch.equal(ri_b.instance.image.buf[lo:lo + PAGE_SIZE],
                               imgs[1][0].buf[lo:lo + PAGE_SIZE])
        ri_a.shutdown()
        ri_b.shutdown()
        server.close()


class TestCrossInstanceFairness:
    def test_light_restore_not_starved_by_heavy_prefetcher(self):
        heavy = make_image(seed=5, hot_pages=16, cold_pages=512, zero_pages=32)
        light = make_image(seed=6, hot_pages=16, cold_pages=64, zero_pages=32)
        pool, master, names = make_stack([heavy, light], names=["heavy", "light"])
        # shallow QP depth: the pump bursts at most 4 posts before blocking on
        # completions, so the light enqueue lands while the heavy walk is queued
        pool.rdma.cost = dataclasses.replace(pool.rdma.cost, max_inflight=4)
        server = NodePageServer("h0", pool, drr_quantum=8 * PAGE_SIZE)
        orch = Orchestrator("h0", pool, master.catalog, node_server=server,
                            prefetch_policy=LayoutOrderPolicy(8))
        ri_h = orch.restore("heavy", pre_install=False, prefetch_cold=False)
        ri_l = orch.restore("light", pre_install=False, prefetch_cold=False)
        ri_h.engine.start_prefetcher(policy=LayoutOrderPolicy(8))  # heavy 1st
        ri_l.engine.start_prefetcher(policy=LayoutOrderPolicy(8))
        assert ri_h.engine.wait_prefetch_idle(60)
        assert ri_l.engine.wait_prefetch_idle(60)

        posts = list(server.post_order)
        h_key = ri_h.engine._group.key
        light_posts = [i for i, (g, _es) in enumerate(posts) if g != h_key]
        heavy_posts = [i for i, (g, _es) in enumerate(posts) if g == h_key]
        n_light = len(light_posts)
        assert n_light >= 8
        assert light_posts[-1] < len(posts) - len(heavy_posts) // 3
        assert light_posts[-1] < 3 * n_light + 16
        assert any(h > light_posts[0] for h in heavy_posts)

        drive_full_restore([ri_h, ri_l], policy=LayoutOrderPolicy(8))
        assert torch.equal(ri_h.instance.image.buf, heavy[0].buf)
        assert torch.equal(ri_l.instance.image.buf, light[0].buf)
        ri_h.shutdown()
        ri_l.shutdown()
        server.close()


class TestExecutedMatchesAnalyticShared:
    """Executed modeled restore time under the LinkArbiter against the
    reference's analytic model (``repro.serve.strategies``, fed the port's
    reader) within the reference test's own 15%, for both runtimes."""

    @pytest.mark.parametrize("shared,same_snapshot,conc,seed", [
        (True, False, 3, 10),
        (True, True, 4, 11),
        (False, True, 3, 12),
        (False, False, 2, 13),
    ])
    def test_executed_within_15pct(self, shared, same_snapshot, conc, seed):
        rng = np.random.default_rng(seed)
        n_imgs = 1 if same_snapshot else conc
        images = [make_image(seed=seed + i,
                             hot_pages=int(rng.integers(32, 160)),
                             cold_pages=int(rng.integers(64, 384)),
                             zero_pages=int(rng.integers(64, 512)))
                  for i in range(n_imgs)]
        pool, master, names = make_stack(images)
        orch = Orchestrator("h0", pool, master.catalog, use_node_server=shared)
        ris = [orch.restore(names[0 if same_snapshot else k],
                            pre_install=False, prefetch_cold=False)
               for k in range(conc)]
        drive_full_restore(ris)
        groups = 1 if (shared and same_snapshot) else conc
        for k, ri in enumerate(ris):
            src = images[0 if same_snapshot else k][0]
            assert torch.equal(ri.instance.image.buf, src.buf)
            t_exec = ri.ledger.total()
            t_model = modeled_concurrent_restore_s(ri.engine.reader, groups)
            assert t_exec == pytest.approx(t_model, rel=0.15), \
                (t_exec, t_model, shared, same_snapshot, conc)
        for ri in ris:
            ri.shutdown()
        orch.close()


class TestStopDrainsInflight:
    def test_stop_returns_demand_buffers_per_instance_engine(self):
        img, ws = make_image(seed=7)
        pool, master, names = make_stack([(img, ws)])
        orch = Orchestrator("h0", pool, master.catalog, use_node_server=False)
        ri = orch.restore(names[0], pre_install=False, prefetch_cold=False)
        cold = ri.engine.reader.cold_page_indices()
        for p in cold[:64]:                  # posts urgent reads, no waiting
            ri.engine.handle_fault(int(p))
        ri.shutdown()                        # stop with reads in flight
        assert ri.engine.buffers.outstanding == 0
        assert ri.engine._inflight == {}
        installed = int(ri.instance.present[cold[:64]].sum())
        assert installed == ri.instance.stats["uffd_copies"]
        assert not ri.engine.link_keys       # arbiter streams unregistered
        orch.close()

    def test_stop_shared_runtime_conserves_buffers(self):
        img, ws = make_image(seed=8)
        pool, master, names = make_stack([(img, ws)])
        server = NodePageServer("h0", pool)
        orch = Orchestrator("h0", pool, master.catalog, node_server=server)
        ri = orch.restore(names[0], pre_install=False, prefetch_cold=False)
        cold = ri.engine.reader.cold_page_indices()
        for p in cold[:32]:
            ri.engine.handle_fault(int(p))
        ri.shutdown()                        # detach parks + drains the host
        assert server.buffers.outstanding == 0
        assert server._pump_thread is None and server._completion_thread is None
        server.close()


# -- deterministic paths through both packages: ledgers key by key ------------

def _both_stacks(seed, k=1):
    arrays, ws = make_arrays(seed=seed, hot_pages=300, cold_pages=200, zero_pages=150)
    out = []
    for mod in (ref, port):
        kw = {} if mod is ref else {"device": "cpu"}
        img = mod.StateImage.build(arrays, **kw)
        pool = mod.HierarchicalPool(64 << 20, 64 << 20, **kw)
        master = mod.PoolMaster(pool)
        master.publish("s", img, ws)
        server = mod.NodePageServer("h0", pool)
        orch = mod.Orchestrator("h0", pool, master.catalog, node_server=server)
        ris = [orch.restore("s", pre_install=False, prefetch_cold=False) for _ in range(k)]
        out.append((img, pool, server, ris))
    return out


def _assert_sessions_equal(r, g):
    (img_r, _, srv_r, ris_r), (img_g, _, srv_g, ris_g) = r, g
    for a, b in zip(ris_r, ris_g):
        assert a.ledger.seconds == b.ledger.seconds        # same floats, same order
        assert a.instance.stats == b.instance.stats
        assert a.engine.reader.view.stats == b.engine.reader.view.stats
        np.testing.assert_array_equal(a.instance.present, b.instance.present)
        np.testing.assert_array_equal(a.instance.image.buf, b.instance.image.buf.numpy())
    assert srv_r.chunks.stats == srv_g.chunks.stats


@pytest.mark.parametrize("chunk", [64, 256])
def test_solo_restore_ledger_equals_reference(chunk):
    r, g = _both_stacks(seed=30)
    for side in (r, g):
        (ri,) = side[3]
        assert ri.engine.pre_install_hot(chunk_pages=chunk) == ri.engine.reader.regions.n_hot
    _assert_sessions_equal(r, g)
    for side in (r, g):
        side[3][0].engine.install_all_sync()
    _assert_sessions_equal(r, g)
    np.testing.assert_array_equal(g[3][0].instance.image.buf.numpy(), r[0].buf)
    for side in (r, g):
        side[3][0].shutdown()
        side[2].close()


@pytest.mark.parametrize("k", [2, 3])
def test_fanout_group_in_fixed_order_ledgers_equal_reference(k):
    """k sessions attach first, then pre-install one after another: the
    first leads every chunk read, the others replay its charge."""
    r, g = _both_stacks(seed=31, k=k)
    for i in range(k):
        for side in (r, g):
            side[3][i].engine.pre_install_hot()
        _assert_sessions_equal(r, g)
    n_chunks = -(-r[3][0].engine.reader.regions.n_hot // RestoreEngine.HOT_CHUNK_PAGES)
    assert g[2].chunks.stats == {"reads": n_chunks, "fanout_hits": (k - 1) * n_chunks,
                                 "cross_group_hits": 0}
    for side in (r, g):
        for ri in side[3]:
            ri.engine.install_all_sync()
    _assert_sessions_equal(r, g)
    for side in (r, g):
        for ri in side[3]:
            ri.shutdown()
        side[2].close()


def test_launch_and_batch_counts_exact_under_thread_contention():
    """The completion worker and every session's thread count launches and
    batches at once: with a shortened switch interval and more threads than
    cores, no increment is lost."""
    import os
    import sys

    from repro_torch.kernels import launch_count

    def wrapper():
        pass

    wrapper.launches = 0
    scatter = FusedScatter().bind_checksums(np.zeros(4, dtype=np.uint32))
    n_threads, per = 2 * (os.cpu_count() or 4), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                launch_count.count(wrapper)
                scatter.count_batch(3)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * per
    assert scatter.stats == {"batches": n_threads * per, "pages": 3 * n_threads * per,
                             "pages_verified": 3 * n_threads * per}
