"""The port's span-and-counter facility (``repro_torch.core.trace``) and what
reads it: off it records nothing; on, spans nest on their thread, carry the
cold start's request id onto the node server's threads, share the torch
profiler's clock, and count one ``serving.extent`` a cold extent and one
fault's hops in order; under the benchmark's traffic at a tiny size, every
cold start and every fault carries its spans."""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.core import trace
from repro_torch.core.pagestore import PAGE_SIZE
from repro_torch.kernels import FusedScatter, launch_count, make_fused_publish_fn

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

@pytest.fixture
def tracing():
    """Tracing on from an empty record; off and empty again afterwards."""
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


def by_name(snap: dict, name: str) -> list:
    return [s for s in snap["spans"] if s[0] == name]


# ------------------------------------------------------------------ the facility

def test_off_records_nothing_and_returns_one_object():
    trace.disable()
    trace.reset()
    a, b = trace.span("a"), trace.span("b", req=3, cpu=True)
    assert a is b
    with trace.span("x"):
        trace.count("c", 5)
        trace.add("q", 1, 2, 7)
    assert trace.now() == 0
    assert trace.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


def test_nesting_gives_parents_and_self_times(tracing):
    token = trace.REQ.set(41)
    try:
        with trace.span("root", cpu=True):
            with trace.span("a"):
                with trace.span("a1", req=9):
                    time.sleep(0.002)
            with trace.span("b"):
                time.sleep(0.001)
    finally:
        trace.REQ.reset(token)
    spans = trace.snapshot()["spans"]
    names = [s[0] for s in spans]
    assert names == ["root", "a", "a1", "b"]          # in the order they began
    parent = {s[0]: (names[s[2]] if s[2] is not None else None) for s in spans}
    assert parent == {"root": None, "a": "root", "a1": "a", "b": "root"}
    assert [s[1] for s in spans] == [41, 41, 9, 41]    # REQ unless given
    assert {s[3] for s in spans} == {threading.get_ident()}
    dur = {s[0]: s[5] - s[4] for s in spans}
    for s in spans:
        kids = [c for c in spans if c[2] is not None and spans[c[2]] is s]
        assert all(s[4] <= c[4] and c[5] <= s[5] for c in kids)
        self_ns = dur[s[0]] - sum(c[5] - c[4] for c in kids)
        assert 0 <= self_ns <= dur[s[0]]
    assert dur["a1"] >= 2_000_000 and dur["b"] >= 1_000_000
    root = spans[0]
    assert root[6] is not None and 0 <= root[6] <= dur["root"]   # its thread's CPU, inside the wall
    assert all(s[6] is None for s in spans[1:])


def test_counters_count_only_while_on_and_launch_counters_always():
    class Wrapper:
        launches = 0

    assert launch_count.count is trace.bump
    trace.reset()
    trace.disable()
    trace.count("device.syncs")
    launch_count.count(Wrapper)
    assert trace.snapshot()["counters"] == {} and Wrapper.launches == 1
    trace.enable()
    try:
        trace.count("device.syncs")
        trace.count("pool.copy_bytes", 4096)
        launch_count.count(Wrapper)
        launch_count.count(Wrapper, "launches")
    finally:
        trace.disable()
    assert trace.snapshot()["counters"] == {"device.syncs": 1, "pool.copy_bytes": 4096}
    assert Wrapper.launches == 3
    trace.reset()
    assert trace.snapshot()["counters"] == {}


def test_launch_counters_hold_under_threads():
    class Wrapper:
        launches = 0

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [launch_count.count(Wrapper)
                                                    for _ in range(2000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert Wrapper.launches == 16000


def test_the_cap_counts_dropped(tracing, monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    trace.add("late", 1, 2)
    snap = trace.snapshot()
    assert [s[0] for s in snap["spans"]] == ["s0", "s1", "s2"]
    assert snap["dropped"] == 3


def test_spans_on_other_threads_and_reset(tracing):
    def work():
        with trace.span("worker", req=5):
            pass

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=10)
    with trace.span("main"):
        trace.reset()               # an open span finishes into the dropped record
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["dropped"] == 0
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=10)
    (w,) = trace.snapshot()["spans"]
    assert w[0] == "worker" and w[1] == 5 and w[3] == t.ident


def test_a_span_encloses_the_profilers_event():
    """The shared clock: a span around ``torch.mm`` under the torch profiler
    encloses the profiler's ``aten::mm`` event."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(128, 128)
    torch.mm(a, a)
    trace.reset()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("mm"):
                torch.mm(a, a)
    finally:
        trace.disable()
    (s,) = trace.snapshot()["spans"]
    trace.reset()
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert events
    e = events[0]
    assert s[4] <= e.start_ns() and e.start_ns() + e.duration_ns() <= s[5]


def test_import_order_has_no_cycle():
    for first in ("repro_torch.kernels", "repro_torch.core.trace", "repro_torch.kernels.rows"):
        code = f"import {first}; import repro_torch.core, repro_torch.kernels; print('ok')"
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=120,
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        assert out.stdout.strip() == "ok", out.stderr


# ------------------------------------------------------------------ in the port

def make_pool(n_pages: int = 1024, seed: int = 5):
    """A published image at test size: runs of zero, hot and cold pages."""
    g = torch.Generator().manual_seed(seed)
    cls = np.tile(np.array([0, 0, 0, 1, 1, 2, 2, 2, 0, 2, 2, 0]), -(-n_pages // 12))[:n_pages]
    buf = torch.randint(1, 256, (n_pages, PAGE_SIZE), dtype=torch.uint8, generator=g)
    buf[torch.from_numpy(cls == 0)] = 0
    manifest = core.Manifest([core.ArrayExtent("guest", 0, n_pages * PAGE_SIZE,
                                               (n_pages * PAGE_SIZE,), "uint8")], n_pages)
    image = core.StateImage(manifest, buf.view(-1))
    pool = core.HierarchicalPool(32 << 20, 64 << 20, device="cpu")
    master = core.PoolMaster(pool, publish_fn=make_fused_publish_fn())
    master.publish("fn", image, np.nonzero(cls == 1)[0])
    return pool, master, image


def restore(pool, master, server):
    orch = core.Orchestrator("h", pool, master.catalog, node_server=server,
                             scatter_fn=FusedScatter())
    ri = orch.restore("fn", pre_install=False)
    assert ri is not None
    return ri


def test_request_id_reaches_the_completion_worker(tracing):
    pool, master, image = make_pool()
    server = core.NodePageServer("h", pool)
    ri = restore(pool, master, server)
    try:
        req = ri.engine.req
        assert req is not None and trace.REQ.get() == req
        cold = ri.engine.reader.cold_page_indices()
        for p in cold[:8].tolist():
            ri.engine.access(p, timeout_s=30)
    finally:
        ri.shutdown()
        server.close()
    snap = trace.snapshot()
    installs = by_name(snap, "nodeserver.install")
    assert len(installs) == 8
    assert {s[1] for s in installs} == {req}
    assert threading.get_ident() not in {s[3] for s in installs}
    (root,) = by_name(snap, "restore")
    assert root[1] == req and root[2] is None
    for name in ("restore.borrow", "restore.invalidate", "restore.machine_state",
                 "restore.instance", "nodeserver.attach"):
        (s,) = by_name(snap, name)
        assert snap["spans"][s[2]] == root and s[1] == req
    assert {s[1] for s in snap["spans"]} == {req}
    assert ri.instance.image.pages_matrix()[cold[:8]].equal(image.pages_matrix()[cold[:8]])


def test_one_extent_span_per_cold_extent(tracing):
    pool, master, image = make_pool(n_pages=2048)
    server = core.NodePageServer("h", pool)
    ri = restore(pool, master, server)
    try:
        ri.engine.pre_install_hot()
        ri.engine.install_all_sync()
        reader = ri.engine.reader
        want = len(list(reader.iter_cold_extents(max_extent_pages=1 << 30,
                                                 largest_first=reader.regions.dedup)))
        assert ri.instance.all_present()
        assert torch.equal(ri.instance.image.buf, image.buf)
    finally:
        ri.shutdown()
        server.close()
    snap = trace.snapshot()
    spans = snap["spans"]
    (cold,) = by_name(snap, "serving.cold_walk")
    extents = [s for s in by_name(snap, "serving.extent") if spans[s[2]] == cold]
    assert want > 1 and len(extents) == want
    hot_walks = by_name(snap, "serving.hot_walk")
    hot_extents = [s for s in by_name(snap, "serving.extent") if spans[s[2]] in hot_walks]
    assert len(hot_extents) == len(list(reader.iter_hot_extents(
        core.RestoreEngine.HOT_CHUNK_PAGES)))
    # each extent's children: its read and the queueing of its rows
    for e in extents:
        kids = [spans[i][0] for i, s in enumerate(spans) if s[2] is not None
                and spans[s[2]] == e]
        assert kids == ["pool.read", "serving.queue"]
    # the walks' flush and route are inside them; cpu time inside the wall
    for w in [cold] + hot_walks:
        assert w[6] is not None and 0 <= w[6] <= w[5] - w[4]
    flush = [s for s in by_name(snap, "serving.flush") if spans[s[2]] == cold]
    assert len(flush) == 1
    assert {"serving.zero_runs", "serving.walk_route", "serving.release",
            "nodeserver.hot_chunk"} <= {s[0] for s in spans}
    c = snap["counters"]
    assert c["nodeserver.hot_chunk_requests"] == len(hot_extents)
    # the offset array, the machine state, and a verify-only launch and a
    # flush a verified walk, each read back once
    assert c["device.syncs"] == 2 + 2 * 2
    assert c["pool.copy_bytes"] >= (ri.engine.reader.regions.n_cold
                                    + ri.engine.reader.regions.n_hot) * PAGE_SIZE


def test_one_faults_hops_lie_in_order_inside_it(tracing):
    pool, master, image = make_pool()
    server = core.NodePageServer("h", pool)
    ri = restore(pool, master, server)
    try:
        page = int(ri.engine.reader.cold_page_indices()[3])
        ri.engine.access(page, timeout_s=30)
    finally:
        ri.shutdown()
        server.close()
    snap = trace.snapshot()
    (fault,) = by_name(snap, "serving.fault")
    hops = [by_name(snap, n) for n in ("rdma.queue_wait", "rdma.read", "rdma.cq_wait",
                                       "nodeserver.install")]
    assert [len(h) for h in hops] == [1, 1, 1, 1]
    qw, rd, cq, inst = (h[0] for h in hops)
    assert {s[1] for s in (fault, qw, rd, cq, inst)} == {ri.engine.req}
    assert fault[4] <= qw[4] <= qw[5] <= rd[4] <= rd[5] <= cq[4] <= cq[5] <= inst[4]
    # the install wakes the fault's waiter: it begins inside the fault and
    # holds the page's bytes by the fault's end
    assert inst[4] <= fault[5]
    assert qw[3] == rd[3] != fault[3]          # the engine's worker thread
    assert cq[3] == inst[3] != fault[3]        # the completion worker


# ------------------------------------------------------------------ under the benchmark's traffic

EAGER_SPANS = ["restore", "restore.borrow", "restore.invalidate", "restore.machine_state",
               "restore.instance", "nodeserver.attach", "nodeserver.hot_chunk",
               "serving.hot_walk", "serving.zero_runs", "serving.walk_route",
               "serving.cold_walk", "serving.extent", "pool.read", "serving.queue",
               "serving.flush", "serving.release"]
FAULT_HOPS = ["rdma.queue_wait", "rdma.read", "rdma.cq_wait", "nodeserver.install"]


def traced_tiny(traffic: str = "") -> tuple:
    """A run of ``fn1g5.eager``'s harness at its tests' size, the program's
    tracing on throughout: the run's record and the program's."""
    from aqbench.tests.conftest import run_tiny

    trace.reset()
    trace.enable()
    try:
        rec = run_tiny("fn1g5.eager", traffic=traffic)
        return rec, trace.snapshot()
    finally:
        trace.disable()
        trace.reset()


@pytest.fixture(scope="module")
def tiny_runs():
    return {"eager": traced_tiny(), "lazy": traced_tiny("lazy")}


def starts(snap: dict) -> set:
    return {s[1] for s in by_name(snap, "restore")}


def test_the_benchmarks_traced_run_leaves_the_programs_tracing_off():
    """The benchmark's own traced run (the torch profiler on) records
    nothing of the program: tracing is switched on only by its caller."""
    from aqbench.tests.conftest import run_tiny

    trace.disable()
    trace.reset()
    rec = run_tiny("fn1g5.eager", trace=True)
    assert rec["done"] > 0
    assert trace.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


@pytest.mark.parametrize("name", EAGER_SPANS)
def test_every_eager_start_has_the_span(tiny_runs, name):
    rec, snap = tiny_runs["eager"]
    assert snap["dropped"] == 0 and rec["failed"] == 0
    reqs = starts(snap)
    assert len(reqs) >= rec["attempted"] > 0 and None not in reqs
    assert {s[1] for s in by_name(snap, name)} == reqs


def test_eager_counters_a_start(tiny_runs):
    rec, snap = tiny_runs["eager"]
    n, c = len(starts(snap)), snap["counters"]
    assert c["nodeserver.hot_chunk_requests"] == len(by_name(snap, "nodeserver.hot_chunk")) == n
    assert c["nodeserver.hot_chunk_requests"] >= rec["counters"]["hot_chunk_requests"]
    assert c["device.syncs"] >= 6 * n
    # every restored page of the window was read from a tier at least once
    assert c["pool.copy_bytes"] >= rec["work"]["restore_pages"] * PAGE_SIZE


@pytest.mark.parametrize("name", FAULT_HOPS)
def test_every_lazy_fault_has_its_hop(tiny_runs, name):
    """The lazy mix faults its cold pages in: each fault's RDMA hops lie
    inside a fault of the same start, one each, and no start walks cold."""
    rec, snap = tiny_runs["lazy"]
    assert snap["dropped"] == 0 and rec["failed"] == 0
    assert by_name(snap, "serving.cold_walk") == []
    faults = by_name(snap, "serving.fault")
    hops = by_name(snap, name)
    assert faults and {s[1] for s in hops} <= starts(snap)
    if name == "nodeserver.install":           # the hot chunks' installs too
        assert len(hops) >= len(faults)
        return
    assert len(hops) == len(faults)
    for h in hops:
        assert any(f[1] == h[1] and f[4] <= h[4] <= h[5] <= f[5] for f in faults)
