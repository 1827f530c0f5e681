"""Port parity of the fleet-serving layer: a twin of each test of
``tests/test_fleet.py``, each running the same seeded scenario through the
JAX package's ``repro.fleet`` and the port's ``repro_torch.fleet`` and
asserting the reference test's own checks on the port's side.  Traces,
profiles (from a dedup pod published in both packages), ``FleetResult``
arrays (``host``, ``mode``, ``ready_s``, ``done_s``, ...), autoscaler
decisions and crash reroutes are ``==`` the reference's."""
import dataclasses
import math

import numpy as np
import pytest

from repro import core as ref_core
from repro import fleet as rf
from repro.serve import strategies as ref_strategies
from repro.sim.clock import VirtualClock as RefVirtualClock
from repro_torch import core as port_core
from repro_torch import fleet as pf
from repro_torch.serve import strategies as port_strategies
from repro_torch.sim.clock import VirtualClock

PAGE = 4096
SIDES = ((rf, RefVirtualClock), (pf, VirtualClock))


def synthetic_profile(mod, fn_id=0, hot=4 << 20, cold=8 << 20, shared=2 << 20):
    return mod.RestoreProfile(
        name=f"fn{fn_id}", version=1, total_pages=(hot + cold) // PAGE,
        hot_bytes=hot, cold_bytes=cold,
        meta_terms=((4e-7 + 4096 / 50e9, 4096),
                    (4e-7 + 8192 / 50e9, 8192)),
        flush_s=1e-5, hot_serial_s=hot / 50e9,
        hot_chunks=max(1, hot // (64 * PAGE)),
        hot_install_s=3e-5, zero_install_s=1e-6,
        cold_serial_s=cold / 12.5e9, cold_install_s=5e-5,
        shared_base_bytes=shared, exclusive_bytes=hot - shared)


def small_stack(mod, n_types=6, n_bases=2, total_rps=200.0):
    fleet = mod.synthesize_fleet(n_types, n_bases, total_rps, seed=7)
    profiles = {f.fn_id: synthetic_profile(mod, f.fn_id) for f in fleet}
    return fleet, profiles


def assert_traces_equal(a, b):
    for key in ("t", "fn", "compute_s"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def assert_results_equal(a, b):
    for key in ("arrival_s", "ready_s", "done_s", "host", "mode", "restarts", "fn"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y)      # exact; NaN where NaN
    assert a.counters == b.counters
    assert (a.host_peak, a.inflight_peak) == (b.host_peak, b.inflight_peak)
    assert a.summary() == b.summary()


def run_both(make_driver, trace_of):
    """``make_driver(mod, clock_cls)`` and ``trace_of(mod)`` through both
    packages; returns the port's result after asserting it equals the
    reference's."""
    out = [make_driver(mod, clock).run(trace_of(mod)) for mod, clock in SIDES]
    assert_results_equal(*out)
    return out[1]


# -- arrivals -----------------------------------------------------------------

def test_trace_bit_deterministic_per_seed():
    fleet_r, _ = small_stack(rf)
    fleet, _ = small_stack(pf)
    assert [dataclasses.asdict(f) for f in fleet_r] == [dataclasses.asdict(f) for f in fleet]
    a = pf.generate_trace(fleet, 10.0, seed=1)
    b = pf.generate_trace(fleet, 10.0, seed=1)
    c = pf.generate_trace(fleet, 10.0, seed=2)
    assert np.array_equal(a.t, b.t) and np.array_equal(a.fn, b.fn)
    assert np.array_equal(a.compute_s, b.compute_s)
    assert not np.array_equal(a.t, c.t)
    assert_traces_equal(rf.generate_trace(fleet_r, 10.0, seed=1), a)
    assert_traces_equal(rf.generate_trace(fleet_r, 10.0, seed=2), c)


def test_trace_independent_of_fleet_order():
    fleet, _ = small_stack(pf)
    a = pf.generate_trace(fleet, 10.0, seed=3)
    b = pf.generate_trace(list(reversed(fleet)), 10.0, seed=3)
    assert np.array_equal(a.t, b.t) and np.array_equal(a.fn, b.fn)
    fleet_r, _ = small_stack(rf)
    assert_traces_equal(rf.generate_trace(list(reversed(fleet_r)), 10.0, seed=3), b)


def test_arrival_means_match_offered_load():
    for gen, args, want, tol in ((
            "poisson_arrivals", (50.0, 200.0), 10_000, 500),
            ("onoff_arrivals", (50.0, 400.0), 20_000, 2_500),
            ("diurnal_arrivals", (50.0, 200.0), 10_000, 1_000)):
        kw = {"mean_on_s": 2.0, "mean_off_s": 8.0} if gen == "onoff_arrivals" else {}
        got = getattr(pf, gen)(np.random.default_rng(0), *args, **kw)
        ref = getattr(rf, gen)(np.random.default_rng(0), *args, **kw)
        np.testing.assert_array_equal(got, ref)
        assert abs(got.size - want) < tol


def test_zipf_rates_heavy_tail():
    r = pf.zipf_rates(100, 1000.0, alpha=1.1)
    assert math.isclose(r.sum(), 1000.0, rel_tol=1e-9)
    assert r[0] > 20 * r[50]
    assert np.all(np.diff(r) <= 0)
    np.testing.assert_array_equal(r, rf.zipf_rates(100, 1000.0, alpha=1.1))


def test_trace_sorted_and_typed():
    fleet, _ = small_stack(pf)
    tr = pf.generate_trace(fleet, 5.0, seed=0)
    assert np.all(np.diff(tr.t) >= 0)
    assert tr.fn.dtype == np.int32 and np.all(tr.compute_s > 0)
    capped = pf.generate_trace(fleet, 5.0, seed=0, max_invocations=50)
    assert len(capped) == 50
    assert_traces_equal(rf.generate_trace(small_stack(rf)[0], 5.0, seed=0,
                                          max_invocations=50), capped)


# -- restore profiles vs the analytic model -----------------------------------

def _dedup_pod(mod):
    """The reference test's three variants in a dedup pod; returns
    ``[(regions, reader, profile)]`` with the profiles built from readers."""
    kw = {} if mod is ref_core else {"device": "cpu"}
    rng = np.random.default_rng(0)
    pool = mod.HierarchicalPool(cxl_capacity=64 << 20, rdma_capacity=256 << 20, **kw)
    master = mod.PoolMaster(pool, dedup=True)
    base = rng.integers(1, 255, 32 * PAGE, dtype=np.int64).astype(np.uint8)
    for v in range(3):
        w = base.copy()
        w[v * PAGE:(v + 1) * PAGE] = rng.integers(1, 255, PAGE).astype(np.uint8)
        img = mod.StateImage.build({
            "w": w,
            "cold": rng.integers(1, 255, 16 * PAGE).astype(np.uint8),
            "z": np.zeros(8 * PAGE, np.uint8),
        }, **kw)
        master.publish(f"v{v}", img, list(range(img.manifest.by_name()["w"].page_count)))
    fleet_mod = rf if mod is ref_core else pf
    out = []
    for v in range(3):
        r = master.catalog.find(f"v{v}").regions
        reader = mod.SnapshotReader(r, pool.host_view(f"p{v}"), pool.rdma)
        excl = mod.exclusive_cxl_bytes(pool, r)
        prof = fleet_mod.profile_reader(reader, shared_base_bytes=r.n_hot * PAGE - excl,
                                        exclusive_bytes=excl)
        out.append((r, reader, prof))
    return out


def test_profile_reproduces_restore_model_exactly():
    ref_side = _dedup_pod(ref_core)
    port_side = _dedup_pod(port_core)
    for (_r, _rd, prof_r), (r, reader, prof) in zip(ref_side, port_side):
        assert dataclasses.asdict(prof) == dataclasses.asdict(prof_r)
        for conc in (1, 2, 8):
            assert prof.cold_start_s(conc) == \
                port_strategies.modeled_concurrent_restore_s(reader, conc)
            assert prof.cold_start_s(conc) == prof_r.cold_start_s(conc)
        if r.name != "v0":
            assert 0 < prof.shared_base_bytes <= r.n_hot * PAGE
        assert prof.install_only_s() < prof.cold_start_s(1)
        assert prof.cold_start_s(1, overlap_frac=0.9) < prof.cold_start_s(1)
        assert prof.cold_start_s(1, overlap_frac=0.9) == prof_r.cold_start_s(1, overlap_frac=0.9)
        assert prof.scaled(4.0).hot_bytes == 4 * prof.hot_bytes
        assert dataclasses.asdict(prof.scaled(1024.0)) == \
            dataclasses.asdict(prof_r.scaled(1024.0))


def test_profile_contention_and_overlap_monotone():
    p, q = synthetic_profile(pf), synthetic_profile(rf)
    assert p.cold_start_s(8) > p.cold_start_s(2) > p.cold_start_s(1)
    assert p.cold_start_s(1, 1.0) < p.cold_start_s(1, 0.5) < p.cold_start_s(1)
    assert p.cold_start_s(4, joined=True) >= p.cold_start_s(1, joined=True)
    for args in ((1,), (2,), (8,), (1, 1.0), (1, 0.5), (4, 0.0, True), (3, 0.25)):
        assert p.cold_start_s(*args) == q.cold_start_s(*args)


# -- keep-warm economics ------------------------------------------------------

def test_keepwarm_break_even_matches_prices():
    restore_s, resident = 20e-3, 256 << 20
    econ = port_strategies.keepwarm_economics(restore_s, 1.0, resident)
    assert econ == ref_strategies.keepwarm_economics(restore_s, 1.0, resident)
    benefit = restore_s - port_strategies.WARM_RESUME_S
    assert math.isclose(econ["benefit_s"], benefit, rel_tol=1e-12)
    assert math.isclose(econ["break_even_gap_s"],
                        benefit / (resident * port_strategies.KEEPWARM_BYTE_S_COST),
                        rel_tol=1e-12)
    gap = econ["break_even_gap_s"]
    assert port_strategies.keepwarm_economics(restore_s, gap * 0.9, resident)["worthwhile"]
    assert not port_strategies.keepwarm_economics(restore_s, gap * 1.1, resident)["worthwhile"]
    assert not port_strategies.keepwarm_economics(
        port_strategies.WARM_RESUME_S / 2, 1e-6, resident)["worthwhile"]


def test_driver_keepwarm_hit_and_expiry():
    prof = synthetic_profile(pf, hot=256 << 20, cold=128 << 20)
    rate = 100.0
    econ = port_strategies.keepwarm_economics(prof.cold_start_s(1), 1.0 / rate,
                                              prof.hot_bytes + prof.cold_bytes)
    assert econ["worthwhile"], "test premise: this fn should be held warm"
    done0 = prof.cold_start_s(1) + 0.01
    gap = 1.0 / rate

    def driver(mod, clock):
        fn = mod.FunctionType(0, "fn0", 0, rate_rps=rate, pattern="poisson",
                              compute_mean_s=0.01)
        return mod.FleetDriver([fn], {0: synthetic_profile(mod, hot=256 << 20, cold=128 << 20)},
                               policy="locality", seed=0, n_hosts=1, clock=clock())

    def trace(ts):
        return lambda mod: mod.Trace(np.array(ts), np.zeros(len(ts), np.int32),
                                     np.full(len(ts), 0.01))

    t2 = done0 + 0.5 * gap
    r = run_both(driver, trace([0.0, t2]))
    assert r.mode[0] == pf.MODE_COLD and r.mode[1] == pf.MODE_WARM
    assert r.counters["warm_hits"] == 1
    assert (r.ready_s[1] - t2) == pytest.approx(port_strategies.WARM_RESUME_S)
    r = run_both(driver, trace([0.0, done0 + 10 * gap]))
    assert r.mode[1] == pf.MODE_COLD
    assert r.counters["keepwarm_expired"] >= 1


# -- placement ----------------------------------------------------------------

def test_locality_joins_active_group():
    prof = synthetic_profile(pf, hot=256 << 20, cold=128 << 20)

    def driver(mod, clock):
        fn = mod.FunctionType(0, "fn0", 0, 10.0, "poisson", 0.5)
        return mod.FleetDriver([fn], {0: synthetic_profile(mod, hot=256 << 20, cold=128 << 20)},
                               policy="locality", seed=0, n_hosts=4, clock=clock(),
                               keep_warm=False)

    r = run_both(driver, lambda mod: mod.Trace(np.array([0.0, 1e-4, 2e-4]),
                                               np.zeros(3, np.int32), np.full(3, 0.5)))
    assert r.mode[0] == pf.MODE_COLD
    assert list(r.mode[1:]) == [pf.MODE_JOIN, pf.MODE_JOIN]
    assert len(set(r.host.tolist())) == 1, "fan-out group on one host"
    assert r.ready_s[2] <= r.ready_s[0] + prof.install_only_s() + 1e-9


def test_locality_prefers_overlap_host():
    def profiles(mod):
        return {i: synthetic_profile(mod, i, hot=256 << 20, cold=0, shared=192 << 20)
                for i in (0, 1)}

    def driver(mod, clock):
        fns = [mod.FunctionType(i, f"fn{i}", 0, 10.0, "poisson", 10.0) for i in (0, 1)]
        return mod.FleetDriver(fns, profiles(mod), policy="locality", seed=0,
                               n_hosts=4, clock=clock(), keep_warm=False)

    r = run_both(driver, lambda mod: mod.Trace(np.array([0.0, 1.0]),
                                               np.array([0, 1], np.int32),
                                               np.array([10.0, 10.0])))
    p1 = profiles(pf)[1]
    assert r.host[1] == r.host[0], "variant routed to base-resident host"
    got = r.ready_s[1] - 1.0
    assert got < p1.cold_start_s(1)
    assert got == pytest.approx(p1.cold_start_s(1, 192 / 256))


def _policy_driver(policy):
    def driver(mod, clock):
        fleet, profiles = small_stack(mod, n_types=12, n_bases=3, total_rps=500.0)
        return mod.FleetDriver(fleet, profiles, policy=policy, seed=5,
                               n_hosts=4, slots_per_host=8, clock=clock(),
                               autoscaler=mod.QueueAutoscaler(min_hosts=4, max_hosts=16))
    return driver


def _policy_trace(mod):
    return mod.generate_trace(small_stack(mod, n_types=12, n_bases=3, total_rps=500.0)[0],
                              6.0, seed=5)


@pytest.mark.parametrize("policy", ["locality", "random", "round_robin"])
def test_policies_deterministic_and_distinct(policy):
    a = run_both(_policy_driver(policy), _policy_trace)
    assert_results_equal(a, _policy_driver(policy)(pf, VirtualClock).run(_policy_trace(pf)))
    if policy == "random":
        loc = _policy_driver("locality")(pf, VirtualClock).run(_policy_trace(pf))
        assert not np.array_equal(loc.host, a.host)


def test_scheduler_rejects_unknown_policy():
    with pytest.raises(ValueError):
        pf.PlacementScheduler("best-fit")
    assert pf.POLICIES == rf.POLICIES


# -- autoscaling --------------------------------------------------------------

def test_autoscaler_hysteresis_and_cooldown():
    steps = [(0.0, 100, 4), (1.0, 100, 5), (6.0, 100, 5), (20.0, 10, 8),
             (30.0, 0, 8), (40.0, 0, 2), (50.0, 10**6, 16), (52.5, 0, 0)]
    kw = dict(min_hosts=2, max_hosts=16, up_queue_per_host=4.0,
              down_queue_per_host=1.0, cooldown_s=5.0)
    a, b = pf.QueueAutoscaler(**kw), rf.QueueAutoscaler(**kw)
    got = [a.decide(t, queued=q, n_alive=n) for t, q, n in steps]
    assert got == [b.decide(t, queued=q, n_alive=n) for t, q, n in steps]
    assert got[0] > 0 and got[1] == 0 and got[2] > 0
    assert got[3] == 0 and got[4] < 0 and got[5] == 0 and got[6] == 0
    assert got[7] == 2


def test_driver_scales_up_under_burst():
    def driver(mod, clock):
        fleet, profiles = small_stack(mod, n_types=4, n_bases=2, total_rps=2000.0)
        return mod.FleetDriver(fleet, profiles, policy="locality", seed=1, n_hosts=2,
                               slots_per_host=8, clock=clock(),
                               autoscaler=mod.QueueAutoscaler(min_hosts=2, max_hosts=64,
                                                              cooldown_s=0.25))

    r = run_both(driver, lambda mod: mod.generate_trace(
        small_stack(mod, n_types=4, n_bases=2, total_rps=2000.0)[0], 4.0, seed=1))
    assert r.counters["scale_ups"] >= 1
    assert r.host_peak > 2
    assert int((~np.isnan(r.done_s)).sum()) == r.arrival_s.size


# -- crash re-routing ---------------------------------------------------------

def test_crash_mid_burst_reroutes_and_completes():
    def driver(mod, clock):
        fleet, profiles = small_stack(mod, n_types=8, n_bases=2, total_rps=800.0)
        return mod.FleetDriver(fleet, profiles, policy="locality", seed=9, n_hosts=3,
                               slots_per_host=8, clock=clock(),
                               autoscaler=mod.QueueAutoscaler(min_hosts=3, max_hosts=32),
                               crash_at=[(1.5, 0)])

    r = run_both(driver, lambda mod: mod.generate_trace(
        small_stack(mod, n_types=8, n_bases=2, total_rps=800.0)[0], 6.0, seed=9))
    assert r.counters["crashes"] == 1
    assert r.counters["crash_requeued"] >= 1
    assert int((~np.isnan(r.done_s)).sum()) == r.arrival_s.size
    rerouted = r.restarts > 0
    assert rerouted.any()
    assert np.all(r.host[rerouted] != 0)
    assert np.all(r.done_s[rerouted] >= 1.5)


def test_crash_rerouted_restores_preserve_pool_invariants():
    """The reference test's crash-and-reroute sequence on the port's
    simulator (CPU pool) and on the reference's: the same trace, events,
    restored records, catalogs, free lists and stores."""
    from repro.sim.cluster import SimCluster as RefSimCluster
    from repro_torch.sim.cluster import SimCluster
    from test_torch_sim_cluster import assert_same

    def drive(sim):
        sim.publish("fnA", 1.0)
        sim.publish("fnB", 2.0)
        for k in range(3):
            sim.add_program(f"rA{k}", sim.restore_program(f"h{k % 2}", "fnA"))
            sim.add_program(f"rB{k}", sim.restore_program(f"h{k % 2}", "fnB"))
        steps, rerouted = 0, False
        while sim.step():
            steps += 1
            if steps == 8 and not rerouted:
                rerouted = True
                for prog in ("rA0", "rA2", "rB0", "rB2"):
                    sim.kill_program(prog)
                for name, fn in (("rA0b", "fnA"), ("rA2b", "fnA"),
                                 ("rB0b", "fnB"), ("rB2b", "fnB")):
                    sim.add_program(name, sim.restore_program("h1", fn))
            if steps > 50_000:
                pytest.fail("sim did not converge")
        assert rerouted
        return sim

    ref_sim = drive(RefSimCluster(n_hosts=3, seed=9))
    sim = drive(SimCluster(n_hosts=3, seed=9, device="cpu"))
    assert_same(ref_sim, sim)
    assert any(e.startswith("crashed:") for e in sim.events)
    done = [(r["host"], r["name"]) for r in sim.restored]
    assert done.count(("h1", "fnA")) >= 3
    assert done.count(("h1", "fnB")) >= 3
    sim.checker.check_all()
    assert len(sim.orphaned_records) == len(ref_sim.orphaned_records) <= 4


@pytest.mark.parametrize("n", [1, 7, 8, 9, 127, 128, 129, 200, 4038, 8192, 8193, 16385,
                               189_870])
def test_float_mean_adds_in_numpys_order(n):
    """``FleetResult.summary``'s mean adds in NumPy 2.0's order (the order of
    the NumPy the reference's committed results were made with), so its
    bits do not depend on the NumPy build the fleet runs under."""
    from repro_torch.fleet.driver import float_mean

    rng = np.random.default_rng(n)
    for x in (rng.lognormal(0.0, 2.0, n), rng.standard_normal(n) * 1e3):
        assert float_mean(x) == float(x.mean())

