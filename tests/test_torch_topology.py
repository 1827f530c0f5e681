"""Port parity of the multi-pod topology under the simulator: every scenario
of ``tests/test_topology_invariants.py`` runs through the JAX package (its
own scenario functions) and through the port's twin in
``scripts/sim_scenarios.py`` on the CPU, across the same seed matrix.  The
runs must agree on the trace, events, restored records, every pod's catalog
words, free lists and dedup refcounts, and the replica manager's, router's,
migrator's and port limiters' stats (demand and served maps included).  The
I7/I8 negative tests fire in the port; the topology objects are held
against the reference directly; and cell (6)'s programs
(``sim_scenarios.topology_cell``) run at a small image."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_topology_invariants as ref_lib
from repro import topology as ref_topo
from repro_torch import core as port_core
from repro_torch import topology as port_topo
from repro_torch.kernels import FusedScatter, fused_publish, fused_restore, make_fused_publish_fn
from repro_torch.sim import InvariantViolation
from test_torch_sim_cluster import port_outcome, ref_outcome

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import sim_scenarios as lib  # noqa: E402

SEED = ref_lib.SEED
PAGE = 4096


def _topology(c) -> dict:
    return {"replicas": dict(c.replicas.stats), "router": dict(c.router.stats),
            "migrator": dict(c.migrator.stats),
            "ports": [dict(p.ports.stats) for p in c.pods],
            "alive": [p.alive for p in c.pods],
            "names": c.replicas.names(),
            "versions": {n: c.replicas.version_of(n) for n in c.replicas.names()},
            "replica_pods": {n: c.replicas.replica_pods(n) for n in c.replicas.names()},
            "demand": {k: dict(v) for k, v in c.replicas.demand.items()},
            "served": {k: dict(v) for k, v in c.replicas.served.items()}}


def assert_same(ref, port) -> None:
    a, b = ref_outcome(ref), port_outcome(port)
    for key in a:
        assert a[key] == b[key], key
    assert _topology(ref) == _topology(port)


@pytest.mark.parametrize("name", sorted(ref_lib.SCENARIOS))
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_scenario_equals_reference(name, offset):
    seed = SEED + 100 * offset + 7 * (sorted(ref_lib.SCENARIOS).index(name) + 1)
    assert seed == lib.topology_seed(name, offset, SEED)
    assert_same(ref_lib.SCENARIOS[name](seed), lib.TOPOLOGY_SCENARIOS[name](seed, "cpu"))


@pytest.mark.parametrize("name", sorted(ref_lib.SCENARIOS))
def test_scenario_is_deterministic(name):
    seed = SEED + 2000 + sorted(ref_lib.SCENARIOS).index(name)
    a = lib.TOPOLOGY_SCENARIOS[name](seed, "cpu")
    b = lib.TOPOLOGY_SCENARIOS[name](seed, "cpu")
    assert a.trace == b.trace and a.events == b.events
    assert port_outcome(a) == port_outcome(b) and _topology(a) == _topology(b)


def test_matrix_twins_every_reference_scenario():
    assert sorted(lib.TOPOLOGY_SCENARIOS) == sorted(ref_lib.SCENARIOS)


# -- the I7/I8 checkers fire in the port ---------------------------------------

def _published(seed=SEED):
    c = lib.pod_cluster(seed, "cpu")
    c.add_program("owner", c.group_publish_program("s", 1.0, pods=[0, 1]))
    c.run()
    return c


def test_i8_bypass_is_detected():
    c = _published()
    img, ws = c.make_image(9.0)

    def rogue():
        for label, _val in c.pods[1].master.publish_steps("s", img, ws):
            yield f"rogue:{label}"

    c.add_program("rogue", rogue())
    with pytest.raises(InvariantViolation, match="I8"):
        c.run()


def test_i7_mixed_versions_are_detected():
    c = _published()
    img, ws = c.make_image(9.0)
    c.pods[1].master.publish("s", img, ws)   # bypass: pod 1 jumps to v1
    with pytest.raises(InvariantViolation, match="I7"):
        c.checker.check_all()


def test_i7_divergent_bytes_are_detected():
    c = _published()
    entry = c.pods[1].catalog.find("s")
    pool = c.pods[1].pool
    r = entry.regions
    page = pool.cxl.read(r.hot_off, PAGE)
    page[:16] ^= 0xFF
    pool.cxl.write(r.hot_off, page)
    c.checker._replica_sigs.pop("s", None)   # force a fresh bit-compare
    with pytest.raises(InvariantViolation, match="I7"):
        c.checker.check_all()


def test_i7_holds_on_identical_replicas_and_caches_the_compare():
    c = _published()
    runs = c.checker.checks_run
    c.checker.check_all()
    assert c.checker.checks_run == runs + 1
    assert c.checker._replica_sigs["s"] == ((0, 0), (1, 0))


# -- the topology objects against the reference, directly ---------------------

def _drive_group(mod, device_kw):
    """A PodGroup of three 2-port pods driven by hand: a replicated publish
    and update, routed borrows, priced reads over the fabric, a partition, a
    migration below and above break-even, a pod loss and a delete."""
    if mod is ref_topo:
        from repro.sim import SimCluster as Cluster
    else:
        from repro_torch.sim import SimCluster as Cluster
    c = Cluster(n_hosts=1, seed=3, n_pods=3, ports_per_pod=2, **device_kw)
    g, mgr, router, mig = c.group, c.replicas, c.router, c.migrator
    for i, h in enumerate(("a", "b", "c", "d", "e")):
        g.assign_host(h, i % 3)
    log = []

    def drive(gen):
        labels = [lbl for lbl, _v in gen]
        log.append(labels)
        return labels

    img, ws = c.make_image(1.0, hot_pages=3, cold_pages=2)
    drive(mgr.publish_steps("s", img, ws, pods=[0, 1]))
    routes = [mgr.borrow_route(h, "s") for h in ("a", "b", "c", "d", "e", "a")]
    charges = [router.charge_read(h, 1, n, ops) for h, n, ops in
               (("c", 4096, 1), ("c", 1 << 20, 256), ("a", 8192, 2))]
    data, t = router.read("c", 1, 0, 0, PAGE)
    g.set_partition(2, 1)
    refused = []
    for dst in (0, 1):
        try:
            router.charge_read("c", dst, PAGE)
            refused.append(False)
        except (ref_topo.PodLinkDown, port_topo.PodLinkDown):
            refused.append(True)
    route_partitioned = mgr.borrow_route("c", "s")
    g.set_partition(2, 1, up=True)
    img2, ws2 = c.make_image(2.0, hot_pages=3, cold_pages=2)
    drive(mgr.publish_steps("s", img2, ws2))
    cold = drive(mig.migrate_steps("s", 2, expected_reads=1))
    econ = mig.economics_for("s", 10_000)
    hot = drive(mig.migrate_steps("s", 2, expected_reads=10_000, drop_source=True))
    lost = mgr.promote(0)
    drive(mgr.delete_steps("s"))
    ports = [(p.ports.in_use(), p.ports.attached("a"), dict(p.ports.stats)) for p in c.pods]
    return {"routes": routes, "charges": charges, "read_charge": t, "read_bytes": int(data.sum()),
            "refused": refused, "route_partitioned": route_partitioned, "log": log,
            "cold": cold, "hot": hot, "econ": econ, "lost": lost, "ports": ports,
            "stats": (dict(mgr.stats), dict(router.stats), dict(mig.stats)),
            "served": {k: dict(v) for k, v in mgr.served.items()},
            "demand": {k: dict(v) for k, v in mgr.demand.items()}}


def test_manager_router_migrator_equal_reference():
    ref = _drive_group(ref_topo, {})
    port = _drive_group(port_topo, {"device": "cpu"})
    assert port == ref
    assert port["refused"] == [False, True]
    assert port["cold"][-1] == "skipped" and port["hot"][-1] == "migrated"
    assert port["stats"][0]["routed_interpod"] > 0 and port["stats"][0]["routed_local"] > 0


def test_inter_pod_cost_and_port_limiter_equal_reference():
    assert vars(port_topo.INTER_POD_COST) == vars(ref_topo.INTER_POD_COST)
    assert port_topo.UNLIMITED_PORTS == ref_topo.UNLIMITED_PORTS
    assert port_topo.split_pod_label("pod3:draining") == ref_topo.split_pod_label("pod3:draining")
    for label in ("pod:x", "podx:y", "barrier", "pod12:gc_done"):
        assert port_topo.split_pod_label(label) == ref_topo.split_pod_label(label)

    def walk(mod):
        lim = mod.PortLimiter(2)
        seen = [lim.try_attach(h) for h in ("a", "a", "b", "c")]
        seen += [lbl for lbl, _h in lim.attach_steps("c", max_polls=3)]
        lim.detach("a")
        seen.append(lim.try_attach("c"))
        lim.detach("a")
        seen += [lbl for lbl, _h in lim.attach_steps("c")]
        return seen, dict(lim.stats), lim.in_use()

    assert walk(port_topo) == walk(ref_topo)


def test_pod_group_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_topo.PodGroup(2)
    g = port_topo.PodGroup(2, cxl_capacity=1 << 20, rdma_capacity=1 << 20, device="cpu")
    assert all(p.pool.cxl.buf.device.type == "cpu" for p in g.pods)
    assert g.clock is port_core.REAL_CLOCK


# -- cell (6) at a small image -------------------------------------------------

def _cell_image(n=512, seed=7):
    """A seeded image with zero, hot and cold pages in runs, on the CPU."""
    rng = np.random.default_rng(seed)
    pages = rng.integers(1, 256, (n, PAGE), dtype=np.uint8)
    zero = np.zeros(n, bool)
    i = 0
    while i < n:                                  # alternating zero / data runs
        z, d = int(rng.geometric(1 / 12)), int(rng.geometric(1 / 8))
        zero[i:i + z] = True
        i += z + d
    pages[zero] = 0
    hot = np.zeros(n, bool)
    for s in rng.integers(0, n, n // 40):
        hot[s:s + int(rng.geometric(1 / 3))] = True
    hot &= ~zero
    man = port_core.Manifest([port_core.ArrayExtent("guest", 0, n * PAGE, (n * PAGE,),
                                                    "uint8")], n)
    img = port_core.StateImage(man, torch.from_numpy(pages.reshape(-1)).clone())
    return img, np.flatnonzero(hot), np.flatnonzero(~hot & ~zero)


def test_topology_cell_at_a_small_image():
    img, ws, cold = _cell_image()
    v1 = lib.rewrite_pages(img, np.concatenate([ws[::3], cold[::5]]), seed=9)
    assert np.array_equal(v1.zero_page_bitmap(), img.zero_page_bitmap())
    fused_publish.launches = fused_restore.launches = 0
    c, rep = lib.topology_cell(0, "cpu", (img, ws), (v1, ws), read_pages=8,
                               cxl_capacity=64 << 20, rdma_capacity=64 << 20,
                               publish_fn=make_fused_publish_fn(),
                               scatter_fn=FusedScatter())
    # the plain versions on CPU tensors count no launch
    assert fused_publish.launches == fused_restore.launches == 0
    assert rep["checks_run"] == rep["steps"] == c.step_no
    assert rep["restored"][0]["version"] in (0, 1)
    assert rep["update_drain_polls"] > 0
    assert min(rep["fallthrough_by_pod"][:2]) > 0
    assert rep["migration"]["expected_reads"] > rep["migration"]["break_even_reads"]
    assert rep["modeled_interpod_s"] > 0
    again, rep2 = lib.topology_cell(0, "cpu", (img, ws), (v1, ws), read_pages=8,
                                    cxl_capacity=64 << 20, rdma_capacity=64 << 20,
                                    publish_fn=make_fused_publish_fn(),
                                    scatter_fn=FusedScatter())
    assert again.trace == c.trace and again.events == c.events
