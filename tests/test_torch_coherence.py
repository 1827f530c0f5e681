"""Port twins of the ownership-protocol tests (§3.3): the protocol itself,
the doomed-borrow regression, the tight borrow loop, failover thread
hygiene, the borrower/owner stress test, the refcount property and the
stateful walks — all against the port's ``Catalog``/``PoolMaster`` on CPU
pools — and the same operation sequence through both packages, which must
leave equal catalogs, regions, tier bytes and free lists."""
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.stateful import (
    RuleBasedStateMachine,
    invariant,
    rule,
    run_state_machine_as_test,
)

from repro import core as ref
from repro.core.profiler import AccessRecorder
from repro_torch import core as port
from repro_torch import interop
from repro_torch.core import (
    STATE_FREE,
    STATE_PUBLISHED,
    STATE_TOMBSTONE,
    Catalog,
    HierarchicalPool,
    LeaseFallback,
    PoolMaster,
    SnapshotReader,
    StateImage,
)


def _pool(mb):
    return HierarchicalPool(mb << 20, mb << 20, device="cpu")


def publish_version(master, name, value, n=2000):
    img = StateImage.build({"data": np.full((n,), value, np.float32)}, device="cpu")
    master.publish(name, img, list(img.manifest.by_name()["data"].pages()))
    return img


def _first_float(page: torch.Tensor) -> float:
    return float(page.view(torch.float32)[0])


class TestProtocol:
    def test_borrow_release(self):
        master = PoolMaster(_pool(32))
        publish_version(master, "s", 1.0)
        b = master.catalog.borrow("s")
        assert b is not None
        entry = master.catalog.find("s")
        assert entry.refcount.load() == 1
        b.release()
        assert entry.refcount.load() == 0

    def test_borrow_fails_on_tombstone(self):
        master = PoolMaster(_pool(32))
        publish_version(master, "s", 1.0)
        master.catalog.tombstone("s")
        assert master.catalog.borrow("s") is None  # → cold start

    def test_no_reclaim_while_borrowed(self):
        pool = _pool(32)
        master = PoolMaster(pool)
        publish_version(master, "s", 1.0)
        b = master.catalog.borrow("s")
        master.delete("s")
        in_use_during_borrow = pool.cxl.bytes_in_use
        assert in_use_during_borrow > 0  # data region NOT freed yet
        b.release()
        master.gc()
        assert pool.cxl.bytes_in_use < in_use_during_borrow

    def test_update_waits_for_borrows(self):
        master = PoolMaster(_pool(64))
        publish_version(master, "s", 1.0)
        b = master.catalog.borrow("s")
        done = threading.Event()

        def update():
            publish_version(master, "s", 2.0)
            done.set()

        t = threading.Thread(target=update, daemon=True)
        t.start()
        time.sleep(0.05)
        assert not done.is_set()          # blocked on the active borrow
        b.release()
        t.join(timeout=5)
        assert done.is_set()
        b2 = master.catalog.borrow("s")
        assert b2.version == 1
        b2.release()

    def test_stale_cache_without_flush_then_flush_fixes(self):
        """The clflushopt step is load-bearing: a host that read v0 and skips
        invalidate() observes stale bytes for v1."""
        pool = _pool(64)
        master = PoolMaster(pool)
        publish_version(master, "s", 1.0)
        view = pool.host_view("h0")
        b0 = master.catalog.borrow("s")
        r0 = SnapshotReader(b0.regions, view, pool.rdma)
        r0.invalidate_cxl()
        page0 = r0.read_page(int(r0.hot_page_indices()[0]))
        b0.release()

        publish_version(master, "s", 2.0)
        b1 = master.catalog.borrow("s")
        r1 = SnapshotReader(b1.regions, view, pool.rdma)
        stale = r1.read_page(int(r1.hot_page_indices()[0]))   # no invalidate
        assert torch.equal(stale[:64], page0[:64])
        r1.invalidate_cxl()
        fresh = r1.read_page(int(r1.hot_page_indices()[0]))
        assert _first_float(fresh) == 2.0
        b1.release()

    def test_lease_fallback(self):
        master = PoolMaster(_pool(32))
        publish_version(master, "s", 1.0)
        leases = LeaseFallback(master.catalog)
        l1 = leases.acquire("s")
        assert l1 is not None
        assert leases.acquire("missing") is None
        l1.release()
        assert leases.rpc_count == 3  # acquire + release + failed acquire


class TestDoomedBorrowRegression:
    def test_owner_tombstone_between_increment_and_cas(self):
        master = PoolMaster(_pool(64))
        publish_version(master, "s", 1.0)
        catalog = master.catalog
        entry = catalog.find("s")
        steps = catalog.borrow_steps("s")
        label, _val = next(steps)
        assert label == "refcount_incremented"
        assert entry.refcount.load() == 1

        img = StateImage.build({"data": np.full((2000,), 2.0, np.float32)}, device="cpu")
        pub = master.publish_steps("s", img, list(img.manifest.by_name()["data"].pages()))
        label, _ = next(pub)
        assert label == "tombstoned"

        label, _ = next(steps)
        assert label == "doomed"
        assert entry.refcount.load() == 0, "doomed borrow must decrement"
        label, borrow = next(steps)
        assert label == "done" and borrow is None, "borrower must cold-start"

        labels = [label for label, _v in pub]
        assert "draining" not in labels, "owner stalled on a doomed borrow"
        assert labels[-1] == "done"
        b = catalog.borrow("s")
        assert b is not None and b.version == 1
        b.release()

    def test_tombstoned_entry_rejected_without_touching_refcount(self):
        master = PoolMaster(_pool(32))
        publish_version(master, "s", 1.0)
        entry = master.catalog.tombstone("s")
        steps = list(master.catalog.borrow_steps("s"))
        assert steps == [("done", None)], "no refcount traffic on TOMBSTONE"
        assert entry.refcount.load() == 0
        labels = [label for label, _v in
                  master.catalog.borrow_steps("s", state_precheck=False)]
        assert "refcount_incremented" in labels and "doomed" in labels
        assert entry.refcount.load() == 0

    def test_owner_drains_against_tight_borrow_loop(self):
        master = PoolMaster(_pool(64))
        publish_version(master, "s", 1.0)
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                b = master.catalog.borrow("s")
                if b is not None:
                    b.release()

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            publish_version(master, "s", 2.0)   # must not TimeoutError
        finally:
            stop.set()
            t.join(timeout=5)
        assert not t.is_alive()
        assert master.catalog.find("s").version == 1


class TestFailoverThreadHygiene:
    def test_stop_and_crash_join_heartbeat_thread(self):
        from repro_torch.core.failover import FailoverNode, MasterLease
        pool = _pool(32)
        master = PoolMaster(pool)
        publish_version(master, "s", 1.0)
        lease = MasterLease(timeout_s=0.1)
        before = set(threading.enumerate())
        n1 = FailoverNode(1, pool, master.catalog, lease, beat_interval_s=0.01)
        n2 = FailoverNode(2, pool, master.catalog, lease, beat_interval_s=0.01)
        n1.start()
        n2.start()
        deadline = time.monotonic() + 5.0
        while not (n1.is_master or n2.is_master):
            assert time.monotonic() < deadline, "no master elected"
            time.sleep(0.005)
        elected = n1 if n1.is_master else n2
        # zero state transfer: the new master re-derives versions from the catalog
        assert elected.master._versions == {"s": 0}
        n1.stop()
        n2.crash()
        assert set(threading.enumerate()) - before == set(), \
            "stop()/crash() must join the heartbeat thread"


class TestStress:
    def test_concurrent_borrowers_vs_owner_updates(self):
        pool = _pool(128)
        master = PoolMaster(pool)
        publish_version(master, "s", 0.0)
        stop = threading.Event()
        errors = []

        def borrower(hid):
            view = pool.host_view(f"h{hid}")
            while not stop.is_set():
                b = master.catalog.borrow("s")
                if b is None:
                    continue
                try:
                    r = SnapshotReader(b.regions, view, pool.rdma)
                    r.invalidate_cxl()
                    vals = {_first_float(r.read_page(int(p)))
                            for p in r.hot_page_indices()[:4]}
                    if len(vals) > 1:
                        errors.append(f"torn read: {vals}")
                finally:
                    b.release()

        threads = [threading.Thread(target=borrower, args=(i,), daemon=True)
                   for i in range(4)]
        for t in threads:
            t.start()
        for v in range(1, 6):
            publish_version(master, "s", float(v))
        stop.set()
        for t in threads:
            t.join(timeout=5)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors

    @given(st.lists(st.sampled_from(["borrow", "release", "tombstone", "publish"]),
                    min_size=1, max_size=40))
    @settings(max_examples=30, deadline=None)
    def test_refcount_never_negative(self, ops):
        catalog = Catalog(capacity=4)
        master = PoolMaster(_pool(32), catalog)
        publish_version(master, "s", 1.0)
        borrows = []
        for op in ops:
            if op == "borrow":
                b = catalog.borrow("s")
                if b:
                    borrows.append(b)
            elif op == "release" and borrows:
                borrows.pop().release()
            elif op == "tombstone":
                catalog.tombstone("s")
            elif op == "publish" and not borrows:
                publish_version(master, "s", 9.0)
            entry = catalog.find("s")
            if entry is not None:
                assert entry.refcount.load() >= 0
                assert entry.state.load() in (STATE_PUBLISHED, STATE_TOMBSTONE)
        for b in borrows:
            b.release()


# -- stateful walks (twins of tests/test_coherence_properties.py) -------------

NAMES = ["alpha", "beta", "gamma"]


class CoherenceMachine(RuleBasedStateMachine):
    def __init__(self):
        super().__init__()
        self.pool = _pool(96)
        self.master = PoolMaster(self.pool, Catalog(capacity=8))
        self.catalog = self.master.catalog
        self.held = []                      # (name, borrow, regions, version)
        self.content = {}                   # name -> version -> StateImage
        self.counter = 0.0

    def _publish(self, name):
        self.counter += 1.0
        img = StateImage.build({
            "hot": np.full(2048, np.float32(self.counter), np.float32),
            "cold": np.arange(1024, dtype=np.float32) + np.float32(self.counter),
        }, device="cpu")
        regions = self.master.publish(name, img, list(img.manifest.by_name()["hot"].pages()))
        self.content.setdefault(name, {})[regions.version] = img

    @rule(name=st.sampled_from(NAMES))
    def publish(self, name):
        entry = self.catalog.find(name)
        if entry is not None and entry.refcount.load() != 0:
            return
        self._publish(name)

    @rule(name=st.sampled_from(NAMES))
    def borrow(self, name):
        b = self.catalog.borrow(name)
        if b is not None:
            self.held.append((name, b, b.regions, b.version))

    @rule(i=st.integers(0, 5))
    def release(self, i):
        if self.held:
            _name, b, _regions, _version = self.held.pop(i % len(self.held))
            b.release()

    @rule(name=st.sampled_from(NAMES))
    def tombstone(self, name):
        self.catalog.tombstone(name)

    @rule(name=st.sampled_from(NAMES))
    def delete(self, name):
        self.master.delete(name)

    @rule()
    def gc(self):
        self.master.gc()

    @rule()
    def verify_held_reads(self):
        for name, b, regions, version in self.held:
            canonical = self.content[name][version].pages_matrix()
            reader = SnapshotReader(regions, self.pool.host_view(f"check{id(b)}"),
                                    self.pool.rdma)
            reader.invalidate_cxl()
            for p in reader.hot_page_indices()[:2]:
                assert torch.equal(reader.read_page(int(p)), canonical[int(p)]), \
                    f"torn/stale read of {name} v{version} page {int(p)}"

    @invariant()
    def refcounts_match_held_borrows(self):
        per_entry = {}
        for _name, b, _regions, _version in self.held:
            per_entry[b.entry.index] = per_entry.get(b.entry.index, 0) + 1
        for entry in self.catalog.entries:
            assert entry.refcount.load() == per_entry.get(entry.index, 0)

    @invariant()
    def held_borrows_stay_pinned(self):
        for _name, b, regions, version in self.held:
            assert b.entry.regions is regions
            assert b.entry.version == version

    @invariant()
    def catalog_states_valid(self):
        for entry in self.catalog.entries:
            state = entry.state.load()
            assert state in (STATE_FREE, STATE_PUBLISHED, STATE_TOMBSTONE)
            if state == STATE_PUBLISHED:
                assert entry.regions is not None

    @invariant()
    def pool_bytes_conserved(self):
        for tier in (self.pool.cxl, self.pool.rdma):
            free = tier.free_list()
            assert sum(s for _o, s in free) + tier.bytes_in_use == tier.capacity
            prev_end = 0
            for off, size in free:
                assert off >= prev_end, f"tier {tier.name}: overlapping free list"
                prev_end = off + size

    def teardown(self):
        for _name, b, _regions, _version in self.held:
            b.release()
        self.master.gc()


def test_coherence_state_machine():
    run_state_machine_as_test(
        CoherenceMachine,
        settings=settings(max_examples=12, stateful_step_count=60, deadline=None))


def test_lease_fallback_state_machine():
    class LeaseMachine(CoherenceMachine):
        def __init__(self):
            super().__init__()
            self.leases = LeaseFallback(self.catalog)

        @rule(name=st.sampled_from(NAMES))
        def lease_borrow(self, name):
            b = self.leases.acquire(name)
            if b is not None:
                self.held.append((name, b, b.regions, b.version))

    run_state_machine_as_test(
        LeaseMachine,
        settings=settings(max_examples=8, stateful_step_count=50, deadline=None))


# -- the same operation sequence through both packages ------------------------

def ref_catalog_state(catalog) -> dict:
    """The reference catalog's words in :func:`interop.catalog_state`'s form
    (the checksum half of each regions pair is compared separately)."""
    entries = []
    for e in catalog.entries:
        state, refcount = e.state.load(), e.refcount.load()
        if state == ref.STATE_FREE and not refcount and not e.name and e.regions is None:
            continue
        entries.append({"index": e.index, "name": e.name, "state": state,
                        "refcount": refcount, "version": e.version,
                        "regions": None if e.regions is None else e.regions.to_dict()})
    return {"capacity": len(catalog.entries), "entries": entries}


def _plain(state: dict) -> dict:
    """A port catalog state with each regions pair cut to its dict."""
    return {"capacity": state["capacity"],
            "entries": [dict(e, regions=None if e["regions"] is None else e["regions"][0])
                        for e in state["entries"]]}


def _image_arrays(value, seed):
    rng = np.random.default_rng(seed)
    return {"hot": np.full(1500, np.float32(value), np.float32),
            "cold": rng.integers(1, 200, (9000,), dtype=np.uint8),
            "zero": np.zeros(3 * 4096, np.uint8)}


SEQUENCE = [("publish", "a", 1.0), ("publish", "b", 2.0), ("borrow", "a", None),
            ("delete", "a", None), ("gc", None, None), ("publish", "b", 3.0),
            ("release", "a", None), ("gc", None, None), ("publish", "c", 4.0),
            ("publish", "a", 5.0), ("tombstone", "c", None), ("borrow", "b", None),
            ("delete", "c", None), ("release", "b", None), ("publish", "b", 6.0)]


@pytest.mark.parametrize("steps", [6, 10, len(SEQUENCE)])
def test_same_sequence_same_catalog_regions_and_bytes(steps):
    """Publish / borrow / delete / gc / update in one order through both
    packages: catalog words, region records, tier bytes and free lists
    stay equal after every step."""
    pools = (ref.HierarchicalPool(8 << 20, 8 << 20),
             port.HierarchicalPool(8 << 20, 8 << 20, device="cpu"))
    masters = (ref.PoolMaster(pools[0], ref.Catalog(capacity=6)),
               port.PoolMaster(pools[1], port.Catalog(capacity=6)))
    held = ({}, {})
    for i, (op, name, value) in enumerate(SEQUENCE[:steps]):
        for side, (mod, master) in enumerate(zip((ref, port), masters)):
            if op == "publish":
                arrays = _image_arrays(value, seed=i)
                img = (mod.StateImage.build(arrays) if mod is ref
                       else mod.StateImage.build(arrays, device="cpu"))
                rec = AccessRecorder(ref.Manifest.from_dict(img.manifest.to_dict()))
                rec.touch_array("hot")
                master.publish(name, img, rec.working_set(), metadata={"step": i})
            elif op == "borrow":
                held[side][name] = master.catalog.borrow(name)
            elif op == "release":
                held[side].pop(name).release()
            elif op == "delete":
                master.delete(name)
            elif op == "tombstone":
                master.catalog.tombstone(name)
            else:
                master.gc()
        assert _plain(interop.catalog_state(masters[1].catalog)) == \
            ref_catalog_state(masters[0].catalog), f"step {i}: {op} {name}"
        for t in ("cxl", "rdma"):
            tr, tg = getattr(pools[0], t), getattr(pools[1], t)
            assert tr._free == tg.free_list()
            assert tr.bytes_in_use == tg.bytes_in_use
            np.testing.assert_array_equal(tr.buf, tg.buf.numpy())
        assert masters[0]._versions == masters[1]._versions
    for side in held:
        for b in side.values():
            b.release()


def test_catalog_state_round_trip():
    pool = port.HierarchicalPool(8 << 20, 8 << 20, device="cpu")
    master = port.PoolMaster(pool, port.Catalog(capacity=5))
    from repro_torch.kernels import make_fused_publish_fn
    for name, v in (("x", 1.0), ("y", 2.0)):
        img = port.StateImage.build(_image_arrays(v, 0), device="cpu")
        master.publish(name, img, list(img.manifest.by_name()["hot"].pages()),
                       publish_fn=make_fused_publish_fn())
    b = master.catalog.borrow("x")
    master.catalog.tombstone("y")
    state = interop.catalog_state(master.catalog)
    back = interop.catalog_from_state(state)
    again = interop.catalog_state(back)
    assert _plain(again) == _plain(state)
    for e0, e1 in zip(state["entries"], again["entries"]):
        if e0["regions"] is not None:
            np.testing.assert_array_equal(e0["regions"][1], e1["regions"][1])
    assert back.find("x").refcount.load() == 1 and back.find("x").version == 0
    assert back.borrow("y") is None                    # tombstoned carries over
    b.release()


def test_recurate_names_its_roadmap_items():
    master = port.PoolMaster(port.HierarchicalPool(8 << 20, 8 << 20, device="cpu"))
    with pytest.raises(NotImplementedError, match="A4c") as err:
        master.recurate("any")
    assert "A8" in str(err.value)
    with pytest.raises(NotImplementedError, match="A4c"):
        next(master.recurate_steps("any"))
