"""Port parity of the deterministic cluster simulator: every scenario of
``tests/test_sim_cluster.py`` runs through the JAX package (its own scenario
functions, as its tests run them) and through the port's twin in
``scripts/sim_scenarios.py`` on the CPU, at the same seed.  The two runs
must agree on the ``(step, program, label)`` trace, the events, the restored
records (ledgers ``==`` key by key), every pod's catalog words and checksum
tables, tier free
lists and dedup store refcounts, the ``FlakyTier`` and fault-injector stats
and the number of invariant checks run.  Also here: the multi-seed sets,
determinism, seed sensitivity, the livelock reproduction, the dedup
scenarios under the ``page_checksum`` store hash, ``FlakyTier`` against the
port's ``FaultInjector``, and the restore walks a ``FlakyTier`` forces per
extent."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import test_sim_cluster as ref_lib
from repro import core as ref_core
from repro.sim import FlakyTier as RefFlakyTier
from repro.sim import SimCluster as RefSimCluster
from repro.sim.clock import VirtualClock as RefVirtualClock
from repro_torch import core as port_core
from repro_torch.core.dedup import poly32_hash_fn
from repro_torch.core.faults import FaultInjector, TierFaultError
from repro_torch.sim import FlakyTier, SimCluster, SimTimeout, VirtualClock
from test_torch_coherence import ref_catalog_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import sim_scenarios as lib  # noqa: E402

SEED = ref_lib.SEED
PAGE = 4096


@pytest.fixture
def flaky_tiers(monkeypatch):
    """Records every FlakyTier either package's scenarios make, in order."""
    made = {"ref": [], "port": []}

    class RefRecording(RefFlakyTier):
        def __init__(self, tier):
            super().__init__(tier)
            made["ref"].append(self)

    class PortRecording(FlakyTier):
        def __init__(self, tier):
            super().__init__(tier)
            made["port"].append(self)

    monkeypatch.setattr(ref_lib, "FlakyTier", RefRecording)
    monkeypatch.setattr(lib, "FlakyTier", PortRecording)
    return made


def _stores(pool):
    return [(dict(s._refs), dict(s.stats)) for s in (pool.dedup_cxl, pool.dedup_rdma)]


def _ref_catalog(catalog) -> dict:
    """The reference catalog in ``lib.outcome``'s form: each regions dict
    beside the bytes of its checksum table (None without one)."""
    state = ref_catalog_state(catalog)
    for d in state["entries"]:
        regions = catalog.entries[d["index"]].regions
        if regions is not None:
            cs = getattr(regions, "page_checksums", None)
            d["regions"] = (d["regions"], None if cs is None
                            else np.asarray(cs).astype(np.uint32).tobytes())
    return state


def ref_outcome(c) -> dict:
    return {
        "trace": list(c.trace), "events": list(c.events), "restored": list(c.restored),
        "checks_run": c.checker.checks_run,
        "catalogs": [_ref_catalog(p.catalog) for p in c.pods],
        "free": [(list(p.pool.cxl._free), list(p.pool.rdma._free)) for p in c.pods],
        "stores": [_stores(p.pool) for p in c.pods],
        "injector": (None if c.pool.fault_injector is None
                     else dict(c.pool.fault_injector.stats)),
    }


port_outcome = lib.outcome


def assert_same(ref, port) -> None:
    a, b = ref_outcome(ref), port_outcome(port)
    for key in a:
        assert a[key] == b[key], key


def _both(name, seed, made=None):
    """The reference's and the port's run of scenario ``name`` at ``seed``
    (a scenario that raises in one must raise the same way in the other)."""
    ref = ref_lib.SCENARIOS[name](seed)
    port = lib.SCENARIOS[name](seed, "cpu")
    assert_same(ref, port)
    if made is not None:
        assert [f.stats for f in made["ref"]] == [f.stats for f in made["port"]]
    return ref, port


def test_scenario_matrix_is_large_enough():
    assert sorted(lib.SCENARIOS) == sorted(ref_lib.SCENARIOS)
    assert len(lib.SCENARIOS) >= 12


@pytest.mark.parametrize("name", sorted(ref_lib.SCENARIOS))
def test_scenario_equals_reference(name, flaky_tiers):
    seed = SEED + 17 * (sorted(ref_lib.SCENARIOS).index(name) + 1)
    assert seed == lib.scenario_seed(name, SEED)
    _both(name, seed, flaky_tiers)
    if name in ("rdma_extent_timeout_retry", "rdma_timeout_exhausts_retries"):
        assert flaky_tiers["port"] and flaky_tiers["port"][0].stats["injected_timeouts"] > 0


@pytest.mark.parametrize("offset", [0, 1, 2])
def test_drift_recuration_multi_seed(offset):
    for name, seed_of in lib.MULTI_SEED["drift"]:
        _both(name, seed_of(offset, SEED))


@pytest.mark.parametrize("offset", [0, 1, 2])
def test_dedup_scenarios_multi_seed(offset):
    for name, seed_of in lib.MULTI_SEED["dedup"]:
        _both(name, seed_of(offset, SEED))


@pytest.mark.parametrize("name", sorted(ref_lib.SCENARIOS))
def test_scenario_is_deterministic(name):
    """Same seed ⇒ identical interleaving, events and outcome, in the port
    and against the reference."""
    seed = SEED + 1000 + sorted(ref_lib.SCENARIOS).index(name)
    a = lib.SCENARIOS[name](seed, "cpu")
    b = lib.SCENARIOS[name](seed, "cpu")
    assert a.trace == b.trace, f"[seed={seed}] {name}: interleaving not reproducible"
    assert a.events == b.events
    assert port_outcome(a) == port_outcome(b)
    assert_same(ref_lib.SCENARIOS[name](seed), a)


def test_different_seeds_change_the_interleaving():
    traces = set()
    for s in range(4):
        c = lib.different_seeds_cluster(SEED + s, "cpu")
        ref = RefSimCluster(n_hosts=3, seed=SEED + s)
        ref.publish("snap", 1.0)
        ref.add_program("owner", ref.publish_program("snap", 2.0))
        for h in ("h1", "h2", "h3"):
            ref.add_program(h, ref.borrower_program(h, "snap", attempts=3))
        ref.run()
        assert_same(ref, c)
        traces.add(tuple(c.trace))
    assert len(traces) > 1


@pytest.mark.parametrize("precheck", [False, True])
def test_livelock_reproduces_like_the_reference(precheck):
    """The doomed-borrow livelock reproduces in the port with the pre-check
    off (the owner's drain times out) and not with it on, trace for trace
    as in the reference."""
    seed = lib.scenario_seed("livelock_when_fix_reverted", SEED)
    port = lib.livelock_run(seed, "cpu", precheck)
    ref = RefSimCluster(n_hosts=3, seed=seed, schedule="round_robin")
    ref.publish("s", 1.0)
    ref.add_program("owner", ref.publish_program("s", 2.0, drain_limit=50))
    ref.add_program("b1", ref.tight_borrower_program("b1", "s", precheck=precheck))
    ref.add_program("b2", ref.tight_borrower_program("b2", "s", precheck=precheck))
    ref.run(max_steps=5000, until=lambda cl: cl._programs["owner"].done)
    assert_same(ref, port)
    assert ("drain_timeout:s" in port.events) is (not precheck)
    assert ("published:s:v1" in port.events) is precheck


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("write", ["publish", "group_publish"])
def test_a_killed_owner_frees_its_claim_while_its_steps_live_on(write, pkg):
    """An owner killed mid-publish whose protocol generators outlive the kill
    (here an extra reference holds each pod master's ``publish_steps``): the
    reference's programs leave them to be finalized when their last
    reference drops, so the owner's claim on the name stays held; the
    port's programs close them at the kill, so the claim is released.  Once
    the extra references go, the reference releases it too."""
    if pkg == "ref":
        c = RefSimCluster(n_hosts=1, seed=SEED, n_pods=2)
    else:
        c = SimCluster(n_hosts=1, seed=SEED, n_pods=2, device="cpu")
    masters = [p.master for p in c.pods]
    kept = []
    for m in masters:
        def keep(*a, _steps=m.publish_steps, **kw):
            gen = _steps(*a, **kw)
            kept.append(gen)
            return gen
        m.publish_steps = keep
    if write == "publish":
        c.fault_plan.kill_after("owner", "publish:built_new")
        c.add_program("owner", c.publish_program("s", 1.0))
    else:
        c.fault_plan.kill_after("owner", "gpub:barrier")
        c.add_program("owner", c.group_publish_program("s", 1.0, pods=[0, 1]))
    c.run(max_steps=1000)
    assert "crashed:owner" in c.events
    assert len(kept) == (1 if write == "publish" else 2)
    held = [m for m in masters if "s" in m._busy_names]
    assert held == (masters[:len(kept)] if pkg == "ref" else [])
    kept.clear()
    assert not any("s" in m._busy_names for m in masters)


@pytest.mark.parametrize("name", lib.DEDUP_SCENARIOS)
def test_dedup_scenarios_under_the_page_checksum_hash(name):
    """Stores hashing with ``page_checksum`` (poly32) make the same sharing
    decisions as FNV-1a: every match is byte-verified, so the outcome and the
    store refcounts equal the FNV run's; only the stores' collision counts
    (same hash, other bytes) differ."""
    seed = lib.scenario_seed(name, SEED)
    fnv = lib.SCENARIOS[name](seed, "cpu")
    poly = lib.SCENARIOS[name](seed, "cpu", dedup_hash_fn=poly32_hash_fn)
    assert poly.pool.dedup_cxl.hash_fn is poly32_hash_fn
    a, b = port_outcome(fnv), port_outcome(poly)
    for key in a:
        if key != "stores":
            assert a[key] == b[key], key
    for pa, pb in zip(a["stores"], b["stores"]):
        for (refs_a, stats_a), (refs_b, stats_b) in zip(pa, pb):
            assert refs_a == refs_b
            assert ({k: v for k, v in stats_a.items() if k != "collisions"}
                    == {k: v for k, v in stats_b.items() if k != "collisions"})


def test_cluster_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimCluster(n_hosts=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimCluster(n_hosts=1, n_pods=2)


def test_cluster_bytes_are_tensors_on_its_device():
    """Tier arenas and canonical content are tensors on the cluster's device."""
    c = lib.SCENARIOS["rdma_extent_timeout_retry"](SEED, "cpu")
    img = c.content["snap"][0]
    assert isinstance(img.buf, torch.Tensor) and img.buf.device == c.device
    assert c.pool.cxl.buf.device == c.pool.rdma.buf.device == c.device


# -- the virtual clock --------------------------------------------------------

def test_virtual_clock_equals_reference():
    import threading

    def walk(clock):
        ev, cv = threading.Event(), threading.Condition()
        seen = [clock.time()]
        clock.advance(0.25)
        clock.sleep(1e-3)
        clock.advance_to(0.1)          # in the past: no-op
        seen.append(clock.monotonic())
        seen.append(clock.wait_event(ev, 0.5))
        ev.set()
        seen.append(clock.wait_event(ev, 0.5))
        with cv:
            seen.append(clock.cv_wait_for(cv, lambda: False, 0.125))
            seen.append(clock.cv_wait_for(cv, lambda: False, None))
        clock.advance_to(3.0)
        seen += [clock.monotonic(), clock.monotonic_ns()]
        return seen

    assert walk(VirtualClock(start=1.5)) == walk(RefVirtualClock(start=1.5))
    with pytest.raises(AssertionError):
        VirtualClock().advance(-1.0)


# -- FlakyTier ----------------------------------------------------------------

class TestFlakyTierParity:
    """The port's FlakyTier against its core FaultInjector: the same
    count-windowed schedules fail the same calls (twin of the reference's
    ``TestFlakyTierParity``)."""

    @staticmethod
    def _access_seq(rng, n=24):
        return [(int(rng.integers(0, 8)) * PAGE,
                 int(rng.integers(1, 3)) * PAGE) for _ in range(n)]

    @given(st.integers(0, 2**31 - 1))
    @settings(max_examples=25, deadline=None)
    def test_read_fault_pattern_matches_injector(self, seed):
        rng = np.random.default_rng(seed)
        windows = [(int(rng.integers(1, 4)),
                    int(rng.integers(0, 4)) * PAGE,
                    int(rng.integers(4, 9)) * PAGE)
                   for _ in range(int(rng.integers(1, 3)))]
        seq = self._access_seq(rng)
        pool = port_core.HierarchicalPool(16 << 20, 16 << 20, device="cpu")
        flaky = FlakyTier(pool.rdma)
        inj = FaultInjector(seed=seed)
        ref_flaky = RefFlakyTier(ref_core.HierarchicalPool(16 << 20, 16 << 20).rdma)
        for n, lo, hi in windows:
            flaky.fail_reads(n, lo, hi)
            inj.fail_reads("rdma", n, lo, hi)
            ref_flaky.fail_reads(n, lo, hi)

        def mask(fn, err=TierFaultError):
            out = []
            for off, nb in seq:
                try:
                    fn(off, nb)
                    out.append(False)
                except err:
                    out.append(True)
            return out

        got = mask(flaky.read)
        assert got == mask(lambda off, nb: inj.check_read("rdma", off, nb))
        assert got == mask(ref_flaky.read, ref_core.TierFaultError)
        assert inj.stats["injected_timeouts"] == flaky.stats["injected_timeouts"]
        assert inj.stats["reads"] == flaky.stats["reads"] == len(seq)
        assert flaky.stats == ref_flaky.stats

    def test_write_fault_pattern_matches_injector(self):
        pool = port_core.HierarchicalPool(16 << 20, 16 << 20, device="cpu")
        flaky = FlakyTier(pool.rdma).fail_writes(2, lo=PAGE, hi=3 * PAGE)
        inj = FaultInjector(seed=0).fail_writes("rdma", 2, lo=PAGE, hi=3 * PAGE)
        page = torch.ones(PAGE, dtype=torch.uint8)
        seq = [0, PAGE, 2 * PAGE, PAGE, 4 * PAGE]
        mine, theirs = [], []
        for off in seq:
            try:
                flaky.write(off, page)
                mine.append(False)
            except TierFaultError:
                mine.append(True)
            try:
                inj.check_write("rdma", off, PAGE)
                theirs.append(False)
            except TierFaultError:
                theirs.append(True)
        assert mine == theirs == [False, True, True, False, False]
        assert (inj.stats["injected_write_faults"]
                == flaky.stats["injected_write_faults"] == 2)
        assert inj.stats["writes"] == flaky.stats["writes"] == len(seq)
        # the writes that passed reached the arena; int32 data counts its bytes
        assert int(pool.rdma.buf[: PAGE].sum()) == PAGE
        with pytest.raises(SimTimeout):
            FlakyTier(pool.rdma).fail_writes(1).write(0, torch.zeros(1024, dtype=torch.int32))


def _restore_through_flaky(mod, n_fail, device_kw):
    """Publish a small image, then restore it through a RestoreSession whose
    reader's RDMA tier is a FlakyTier failing its first ``n_fail`` reads:
    ``install_all_sync`` retries each through ``call_with_retries``."""
    rng = np.random.default_rng(5)
    arrays = {"hot": rng.standard_normal(3 * PAGE // 4).astype(np.float32),
              "cold": rng.integers(1, 200, (9 * PAGE,), dtype=np.uint8),
              "zero": np.zeros(2 * PAGE, np.uint8)}
    img = mod.StateImage.build(arrays, **device_kw)
    rec = mod.AccessRecorder(img.manifest)
    rec.touch_array("hot")
    pool = mod.HierarchicalPool(16 << 20, 16 << 20, **device_kw)
    regions = mod.build_snapshot(pool, img, rec.working_set(), "s")
    clock = (RefVirtualClock() if mod is ref_core else VirtualClock())
    flaky = (RefFlakyTier if mod is ref_core else FlakyTier)(pool.rdma).fail_reads(n_fail)
    reader = mod.SnapshotReader(regions, pool.host_view("h"), flaky)
    reader.invalidate_cxl()
    inst = mod.Instance(mod.StateImage.empty_like(img.manifest, **device_kw), clock=clock)
    session = mod.RestoreSession(reader, inst, None, clock=clock)
    session.install_all_sync()
    buf = inst.image.buf
    same = (np.array_equal(buf, img.buf) if mod is ref_core else torch.equal(buf, img.buf))
    return session, flaky, inst, clock, same


@pytest.mark.parametrize("n_fail", [0, 2])
def test_flaky_tier_forces_walks_per_extent_and_retries_like_the_reference(n_fail):
    ref = _restore_through_flaky(ref_core, n_fail, {})
    port = _restore_through_flaky(port_core, n_fail, {"device": "cpu"})
    session, flaky, inst, clock, same = port
    assert same and ref[4]
    # both bulk walks read through the proxy's reader: neither is batched
    assert session.walk_routes["batched"] == 0
    assert session.walk_routes["per_extent"]["injector"] == 2
    assert flaky.stats == ref[1].stats
    assert flaky.stats["injected_timeouts"] == n_fail
    assert session.retry_trace == ref[0].retry_trace and len(session.retry_trace) == n_fail
    assert inst.ledger.seconds == ref[2].ledger.seconds
    assert inst.stats == ref[2].stats
    assert clock.monotonic() == ref[3].monotonic()


def test_a_plain_tier_batches_the_same_walks():
    """The control: without the proxy both walks take the batched route."""
    rng = np.random.default_rng(5)
    img = port_core.StateImage.build(
        {"hot": rng.standard_normal(3 * PAGE // 4).astype(np.float32),
         "cold": rng.integers(1, 200, (9 * PAGE,), dtype=np.uint8)}, device="cpu")
    rec = port_core.AccessRecorder(img.manifest)
    rec.touch_array("hot")
    pool = port_core.HierarchicalPool(16 << 20, 16 << 20, device="cpu")
    regions = port_core.build_snapshot(pool, img, rec.working_set(), "s")
    reader = port_core.SnapshotReader(regions, pool.host_view("h"), pool.rdma)
    reader.invalidate_cxl()
    inst = port_core.Instance(port_core.StateImage.empty_like(img.manifest, device="cpu"))
    session = port_core.RestoreSession(reader, inst, None)
    session.install_all_sync()
    assert torch.equal(inst.image.buf, img.buf)
    assert session.walk_routes["batched"] == 2
    assert session.walk_routes["per_extent"]["injector"] == 0
