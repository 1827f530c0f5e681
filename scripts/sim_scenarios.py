"""The deterministic cluster simulator's scenario library for the PyTorch port.

Every scenario is a function ``scenario_<name>(seed, device)`` that builds a
:class:`repro_torch.sim.SimCluster` on ``device``, schedules host programs
against the port's production objects, injects the scripted faults, asserts
the outcome and returns the cluster (its ``trace``, ``events``,
``restored``, pods, fault stats and ``checker`` are what callers compare).
The invariant checker (I1–I8) runs after every step inside the simulator.

* :data:`SCENARIOS` — the single-pod matrix (coherence, failover, faults,
  dedup, re-curation, chaos);
* :data:`TOPOLOGY_SCENARIOS` — the multi-pod matrix (replication, routing,
  partitions, pod loss, migration);
* :func:`scenario_seed`, :func:`topology_seed`, :data:`MULTI_SEED` — the seeds
  the repo's tests run each scenario at;
* :func:`topology_cell` — cell (6)'s programs on a 3-pod cluster, at any
  image size (``chip_smoke.py`` runs it at the 1.5 GiB instance);
* :func:`cuda_parity` — one scenario on the card and on the CPU, the two runs
  compared.

The dedup scenarios take ``dedup_hash_fn`` (``None``: FNV-1a-64; pass
``repro_torch.core.dedup.poly32_hash_fn`` for the ``page_checksum`` kernel as
the stores' hash), set on the cluster's two dedup stores before the first
publish: the hash changes no sharing decision, so the trace is the same.
Imports nothing but the port, numpy and torch.
"""
from __future__ import annotations

import random
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (  # noqa: E402
    STATE_FREE,
    STATE_PUBLISHED,
    STATE_TOMBSTONE,
    FaultInjector,
    HeatRegistry,
    SnapshotReader,
    StateImage,
    TouchEvent,
    reconstruct_image,
)
from repro_torch import interop  # noqa: E402
from repro_torch.core.coherence import LeaseFallback  # noqa: E402
from repro_torch.kernels import FusedScatter, make_fused_publish_fn  # noqa: E402
from repro_torch.sim import FlakyTier, SimCluster, SimTimeout  # noqa: E402
from repro_torch.topology import INTER_POD_COST  # noqa: E402

PAGE = 4096


# ---------------------------------------------------------------------------
# single-pod scenarios
# ---------------------------------------------------------------------------

def scenario_steady_borrow_release(seed, device):
    """2 hosts looping borrow/verify/release against a stable snapshot."""
    c = SimCluster(n_hosts=2, seed=seed, device=device)
    c.publish("snap", 1.0)
    c.add_program("h1", c.borrower_program("h1", "snap", attempts=4))
    c.add_program("h2", c.borrower_program("h2", "snap", attempts=4))
    c.run()
    assert "borrower_done:h1:4/4" in c.events
    assert "borrower_done:h2:4/4" in c.events
    assert c.catalog.find("snap").refcount.load() == 0
    return c


def scenario_owner_update_vs_borrowers(seed, device):
    """3 borrower hosts racing owner updates: every successful borrow reads
    single-version data; the final catalog version is the owner's last."""
    c = SimCluster(n_hosts=3, seed=seed, device=device)
    c.publish("snap", 1.0)
    c.add_program("owner", c.publish_program("snap", 2.0))
    for h in ("h1", "h2", "h3"):
        c.add_program(h, c.borrower_program(h, "snap", attempts=3))
    c.run()
    assert "published:snap:v1" in c.events
    entry = c.catalog.find("snap")
    assert entry.version == 1 and entry.state.load() == STATE_PUBLISHED
    assert entry.refcount.load() == 0
    return c


def scenario_doomed_borrow_interleaving(seed, device):
    """The owner tombstones *between* the borrower's refcount increment and
    its state CAS: the borrower backs out and cold-starts; the owner drains
    without a single stall poll."""
    c = SimCluster(n_hosts=2, seed=seed, schedule="round_robin", device=device)
    c.publish("s", 1.0)

    def borrower_once(host):
        rec = yield from c.borrow_program_steps(host, "s")
        assert rec is None, "borrow should be doomed by the interleaved tombstone"
        c.events.append(f"cold_start:{host}")
        yield "borrower:cold_start"

    c.add_program("h1", borrower_once("h1"))              # rr slot 1: refcount++
    c.add_program("owner", c.publish_program("s", 2.0))   # rr slot 2: tombstone
    c.run()
    labels = [lbl for _s, _p, lbl in c.trace]
    assert "borrow:refcount_incremented" in labels and "borrow:doomed" in labels
    assert labels.index("borrow:refcount_incremented") \
        < labels.index("publish:tombstoned") < labels.index("borrow:doomed")
    assert "publish:draining" not in labels, "owner stalled on a doomed borrow"
    assert "cold_start:h1" in c.events and "published:s:v1" in c.events
    return c


def livelock_run(seed, device, precheck):
    """One run of the doomed-borrow livelock setup: an owner update with a
    50-poll drain limit against two tight-loop borrowers, round robin."""
    c = SimCluster(n_hosts=3, seed=seed, schedule="round_robin", device=device)
    c.publish("s", 1.0)
    c.add_program("owner", c.publish_program("s", 2.0, drain_limit=50))
    c.add_program("b1", c.tight_borrower_program("b1", "s", precheck=precheck))
    c.add_program("b2", c.tight_borrower_program("b2", "s", precheck=precheck))
    c.run(max_steps=5000, until=lambda cl: cl._programs["owner"].done)
    return c


def scenario_livelock_when_fix_reverted(seed, device):
    """Without the borrow's state pre-check (``precheck=False``) the owner's
    drain livelocks against tight-loop borrowers; the same seed with the
    pre-check completes.  Round robin pins the adversarial interleaving for
    any seed."""
    broken = livelock_run(seed, device, precheck=False)
    assert "drain_timeout:s" in broken.events, \
        f"[seed={seed}] expected livelock with the fix reverted"
    assert "published:s:v1" not in broken.events
    fixed = livelock_run(seed, device, precheck=True)
    assert "published:s:v1" in fixed.events and "drain_timeout:s" not in fixed.events
    return fixed


def scenario_host_crash_mid_borrow(seed, device):
    """Host dies between refcount++ and the CAS: the increment leaks, the
    owner's drain times out, and the checker's accounting still matches the
    shared word exactly."""
    c = SimCluster(n_hosts=2, seed=seed, schedule="round_robin", device=device)
    c.publish("s", 1.0)
    c.fault_plan.kill_after("h1", "borrow:refcount_incremented")
    c.add_program("h1", c.borrower_program("h1", "s", attempts=1))
    c.add_program("owner", c.publish_program("s", 2.0, drain_limit=30))
    c.run(max_steps=2000)
    entry = c.catalog.find("s")
    assert "crashed:h1" in c.events
    assert "drain_timeout:s" in c.events, "owner should time out on the leaked refcount"
    assert entry.refcount.load() == 1 and c.midflight[(0, entry.index)] == 1
    assert entry.state.load() == STATE_TOMBSTONE
    return c


def scenario_host_crash_holding_borrow(seed, device):
    """Host dies while holding a successful borrow: the refcount leak is an
    orphan record; the owner cannot drain; data stays pinned."""
    c = SimCluster(n_hosts=2, seed=seed, device=device)
    c.publish("s", 1.0)
    c.fault_plan.kill_after("h1", "borrower:flushed")
    c.add_program("h1", c.borrower_program("h1", "s", attempts=1))
    c.add_program("owner", c.delayed(0.01, c.publish_program("s", 2.0, drain_limit=30)))
    c.run(max_steps=2000)
    assert "crashed:h1" in c.events and "drain_timeout:s" in c.events
    assert len(c.orphaned_records) == 1
    orphan = c.orphaned_records[0]
    assert orphan.borrow.entry.regions is orphan.regions, \
        "orphaned borrow's data was rewritten"
    return c


def scenario_owner_crash_between_tombstone_and_republish(seed, device):
    """Owner dies mid-update (after tombstone, before republish): borrowers
    cold-start but never see torn bytes; an elected failover master
    republishes and borrows succeed again."""
    c = SimCluster(n_hosts=3, seed=seed, device=device)
    c.publish("s", 1.0)
    for nid in c.nodes:
        c.add_heartbeat(nid)
    c.fault_plan.kill_after("owner", "publish:tombstoned")
    c.add_program("owner", c.publish_program("s", 2.0))
    c.add_program("h1", c.delayed(0.01, c.borrower_program("h1", "s", attempts=2)))
    c.run(max_steps=4000, until=lambda cl: cl._programs["h1"].done)
    assert "crashed:owner" in c.events
    assert c.events.count("cold_start:h1") == 2, "tombstoned entry must cold-start"
    new_master = c.elected_master()
    assert new_master is not None, "no failover master elected"
    c.add_program("recovery", c.publish_program("s", 3.0, master=new_master))
    c.add_program("h2", c.delayed(0.005, c.borrower_program("h2", "s", attempts=2)))
    c.run(max_steps=8000, until=lambda cl: cl._programs["h2"].done)
    assert "published:s:v1" in c.events
    assert "borrower_done:h2:2/2" in c.events
    return c


def scenario_master_failover_basic(seed, device):
    """4 nodes: first election, master crash, exactly one successor."""
    c = SimCluster(n_hosts=4, seed=seed, device=device)
    c.publish("snap", 1.0)
    for nid in c.nodes:
        c.add_heartbeat(nid)
    c.run(max_steps=200, until=lambda cl: cl.elected_master() is not None)
    first = [n.node_id for n in c.nodes.values() if n.is_master]
    assert len(first) == 1 and c.lease.term.load() == 1
    c.crash_node(first[0])
    c.run(max_steps=6000,
          until=lambda cl: any(n.is_master for n in cl.nodes.values()
                               if n.node_id != first[0]))
    second = [n.node_id for n in c.nodes.values() if n.is_master]
    assert len(second) == 1 and second[0] != first[0]
    assert c.lease.term.load() == 2
    assert c.checker.term_history == {1: first[0], 2: second[0]}
    return c


def scenario_master_failover_races_8_hosts(seed, device):
    """8 nodes race a repeatedly-crashing master: every term has exactly one
    winner (I2 is checked at every step of every election)."""
    c = SimCluster(n_hosts=8, seed=seed, device=device)
    for nid in c.nodes:
        c.add_heartbeat(nid)
    dead = []
    for round_no in range(3):
        c.run(max_steps=c.step_no + 8000,
              until=lambda cl: any(n.is_master for n in cl.nodes.values()
                                   if n.node_id not in dead))
        masters = [n.node_id for n in c.nodes.values() if n.is_master]
        assert len(masters) == 1, f"round {round_no}: masters={masters}"
        dead.append(masters[0])
        c.crash_node(masters[0])
    assert c.lease.term.load() == 3
    assert sorted(c.checker.term_history) == [1, 2, 3]
    assert len(set(c.checker.term_history.values())) == 3, \
        "a node won two terms it shouldn't have"
    return c


def scenario_lease_expiry_during_gc(seed, device):
    """The master's heartbeat stalls mid-GC (the lease expires while a
    tombstoned entry drains); a new master is elected, the old GC still
    completes, and pool accounting stays conserved throughout."""
    c = SimCluster(n_hosts=3, seed=seed, device=device)
    for nid in c.nodes:
        c.add_heartbeat(nid)
    c.run(max_steps=200, until=lambda cl: cl.elected_master() is not None)
    old_master = c.elected_master()
    old_id = [n.node_id for n in c.nodes.values() if n.is_master][0]
    c.publish("s0", 1.0, master=old_master)
    in_use_before = c.pool.cxl.bytes_in_use

    def holder(host):
        rec = yield from c.borrow_program_steps(host, "s0")
        assert rec is not None
        yield ("sleep", 0.3)        # hold across the lease expiry
        yield "holder:waking"
        c.release(rec)
        yield "holder:released"

    c.add_program("h1", holder("h1"))
    c.add_program("gc", c.delayed(0.01, c.delete_program(
        "s0", master=old_master, gc_polls=40, gc_sleep=0.02)))
    # the stall: the old master's heartbeat dies right after the delete starts
    c.fault_plan.kill_after(f"hb{old_id}", "tick", occurrence=3)
    c.run(max_steps=20000)
    assert c.lease.term.load() >= 2, "lease should have changed hands mid-GC"
    assert len(set(c.checker.term_history.values())) >= 2
    entry_states = [e.state.load() for e in c.catalog.entries if e.name == "s0"]
    assert not entry_states, "s0 should be fully reclaimed after the held borrow"
    assert c.pool.cxl.bytes_in_use < in_use_before
    return c


def scenario_rdma_extent_timeout_retry(seed, device):
    """Injected RDMA extent timeouts: the restore retries with backoff and
    still produces a bit-identical image (verified inside the program)."""
    c = SimCluster(n_hosts=2, seed=seed, device=device)
    c.publish("snap", 3.0, hot_pages=4, cold_pages=6, zero_pages=2)
    flaky = FlakyTier(c.pool.rdma).fail_reads(3)
    c.add_program("h1", c.restore_program("h1", "snap", rdma=flaky))
    c.run()
    assert len(c.restored) == 1
    assert c.restored[0]["retries"] == 3
    assert flaky.stats["injected_timeouts"] == 3
    assert c.catalog.find("snap").refcount.load() == 0
    return c


def scenario_rdma_timeout_exhausts_retries(seed, device):
    """Unrecoverable RDMA timeouts: the restore aborts cleanly — the borrow
    is released (no refcount leak) before the failure propagates."""
    c = SimCluster(n_hosts=2, seed=seed, device=device)
    c.publish("snap", 3.0, cold_pages=4)
    flaky = FlakyTier(c.pool.rdma).fail_reads(100)
    c.add_program("h1", c.restore_program("h1", "snap", rdma=flaky, max_retries=2))
    try:
        c.run()
        raised = False
    except SimTimeout:
        raised = True
    assert raised, "restore should abort once retries are exhausted"
    assert c.catalog.find("snap").refcount.load() == 0, "borrow leaked on abort"
    assert not c.restored
    return c


def scenario_batched_vs_perpage_restore_under_updates(seed, device):
    """Batched and per-page restores of the same snapshot, concurrent with an
    owner update: both are bit-identical to the version they borrowed, and
    both install the same page counts."""
    c = SimCluster(n_hosts=3, seed=seed, device=device)
    c.publish("snap", 1.0, hot_pages=5, cold_pages=7, zero_pages=3)
    c.add_program("batched", c.restore_program("batched", "snap", use_batch=True))
    c.add_program("perpage", c.restore_program("perpage", "snap", use_batch=False))
    c.add_program("owner", c.publish_program("snap", 2.0))
    c.run()
    assert "published:snap:v1" in c.events
    done = {r["host"]: r for r in c.restored}
    for host in ("batched", "perpage"):
        assert host in done or f"cold_start:{host}" in c.events
    if "batched" in done and "perpage" in done \
            and done["batched"]["version"] == done["perpage"]["version"]:
        assert done["batched"]["uffd_copies"] == done["perpage"]["uffd_copies"]
        assert done["batched"]["uffd_zeropages"] == done["perpage"]["uffd_zeropages"]
    return c


def scenario_eviction_under_borrows(seed, device):
    """Eviction racing a live borrow: victims are reclaimed, but the borrowed
    snapshot's bytes stay resident until release, then drain."""
    c = SimCluster(n_hosts=2, seed=seed, device=device)
    for i in range(3):
        c.publish(f"s{i}", float(i))

    def borrower_hold(host):
        rec = yield from c.borrow_program_steps(host, "s0")
        assert rec is not None
        yield ("sleep", 0.02)
        yield "holder:waking"
        c.release(rec)
        yield "holder:released"

    def evictor():
        yield ("sleep", 0.005)      # let the borrow land first
        evicted = c.master.evict_for(1 << 30)
        c.events.append("evicted:" + ",".join(sorted(evicted)))
        yield "evicted"
        for _ in range(40):
            c.master.gc()
            if not c.master._pending_reclaim:
                break
            yield ("sleep", 1e-3)
            yield "gc_poll"
        yield "evictor:done"

    c.add_program("h1", borrower_hold("h1"))
    c.add_program("evict", evictor())
    c.run(max_steps=20000)
    assert "evicted:s0,s1,s2" in c.events
    assert c.pool.cxl.bytes_in_use == 0, "everything should drain post-release"
    assert all(e.state.load() == STATE_FREE for e in c.catalog.entries)
    return c


def scenario_catalog_churn(seed, device):
    """4 hosts doing seeded random publish/delete/borrow/release churn over a
    shared namespace — the invariant checker is the oracle."""
    c = SimCluster(n_hosts=4, seed=seed, device=device)
    names = ["a", "b"]
    for i, n in enumerate(names):
        c.publish(n, float(i))

    def churn(host, sub_seed):
        rng = random.Random(sub_seed)
        held = []
        for i in range(25):
            op = rng.choice(["borrow", "borrow", "release", "publish", "delete", "gc"])
            name = rng.choice(names)
            if op == "borrow":
                rec = yield from c.borrow_program_steps(host, name)
                if rec is not None:
                    held.append(rec)
            elif op == "release" and held:
                c.release(held.pop(rng.randrange(len(held))))
                yield "churn:released"
            elif op == "publish":
                yield from c.publish_program(name, 10.0 * sub_seed + i,
                                             drain_limit=200)
            elif op == "delete":
                c.master.delete(name)
                yield "churn:deleted"
            else:
                c.master.gc()
                yield "churn:gc"
            yield ("sleep", 1e-5)
        for rec in held:
            c.release(rec)
        yield "churn:drained"

    for i in range(4):
        c.add_program(f"h{i}", churn(f"h{i}", seed * 13 + i))
    c.run(max_steps=30000)
    c.master.gc()
    for e in c.catalog.entries:
        assert e.refcount.load() == 0
    return c


def scenario_delete_during_update_drain(seed, device):
    """A delete()+gc() issued while an update is draining must not
    double-free the old regions (I3 would catch the duplicate free on the
    very step it happens)."""
    c = SimCluster(n_hosts=2, seed=seed, device=device)
    c.publish("s", 1.0)

    def holder(host):
        rec = yield from c.borrow_program_steps(host, "s")
        assert rec is not None
        yield ("sleep", 0.01)       # keep the update draining for a while
        yield "holder:waking"
        c.release(rec)
        yield "holder:released"

    def deleter():
        yield ("sleep", 0.002)      # land mid-drain, after the tombstone
        c.master.delete("s", gc_now=False)
        yield "deleter:deleted"
        for _ in range(30):         # hammer gc across the drain window
            c.master.gc()
            yield "deleter:gc"
            yield ("sleep", 1e-3)

    c.add_program("h1", holder("h1"))
    c.add_program("owner", c.delayed(0.001, c.publish_program("s", 2.0)))
    c.add_program("del", deleter())
    c.run(max_steps=30000)
    assert "published:s:v1" in c.events     # the update completed safely
    assert c.catalog.find("s").refcount.load() == 0
    assert not c.master._pending_reclaim
    return c


def scenario_owner_crash_after_freeing_old(seed, device):
    """Owner dies after freeing the old regions but before republish: the
    tombstoned entry keeps no dangling regions pointer, and a later
    delete+gc reclaims it without freeing the same bytes twice."""
    c = SimCluster(n_hosts=2, seed=seed, device=device)
    c.publish("s", 1.0)
    c.fault_plan.kill_after("owner", "publish:freed_old")
    c.add_program("owner", c.publish_program("s", 2.0))
    c.run(max_steps=2000)
    assert "crashed:owner" in c.events
    entry = c.catalog.find("s")
    assert entry is not None and entry.regions is None, \
        "freed regions must not dangle off the entry"

    def janitor():
        c.master.delete("s", gc_now=False)
        yield "janitor:deleted"
        c.master.gc()
        yield "janitor:gc"

    c.add_program("janitor", janitor())
    c.run(max_steps=4000)
    assert c.catalog.find("s") is None, "entry should be reclaimed"
    assert not c.master._pending_reclaim
    return c


def scenario_lease_fallback(seed, device):
    """RPC-lease fallback (no cross-host atomics): acquire/release from two
    hosts against owner churn; refcount accounting holds (I1 covers the
    fallback path too via track_borrow)."""
    c = SimCluster(n_hosts=2, seed=seed, device=device)
    c.publish("s", 1.0)
    leases = LeaseFallback(c.catalog)

    def lease_user(host, n):
        for i in range(n):
            rec = c.track_borrow(host, "s", leases.acquire("s"))
            yield "lease:acquire"
            if rec is not None:
                canonical = c.content["s"][rec.version].pages_matrix()
                view = c.pool.host_view(f"{host}:{i}")
                reader = SnapshotReader(rec.borrow.regions, view, c.pool.rdma)
                reader.invalidate_cxl()
                page = int(reader.hot_page_indices()[0])
                assert torch.equal(reader.read_page(page), canonical[page])
                c.release(rec)
                yield "lease:release"
            yield ("sleep", 1e-4)

    c.add_program("h1", lease_user("h1", 3))
    c.add_program("h2", lease_user("h2", 3))
    c.add_program("owner", c.delayed(2e-4, c.publish_program("s", 2.0)))
    c.run(max_steps=10000)
    assert leases.rpc_count >= 6
    assert c.catalog.find("s").refcount.load() == 0
    return c


def scenario_drift_recuration_feedback(seed, device):
    """Working-set drift closed loop: borrowers demand-fault cold pages and
    record heat; the owner re-curates once the modeled benefit clears the
    break-even; a later restore of the re-curated version is bit-identical
    and finds the drifted pages promoted into the hot set."""
    c = SimCluster(n_hosts=3, seed=seed, device=device)
    c.publish("s", 1.0, cold_pages=4)
    registry = HeatRegistry(clock=c.clock, half_life_s=1e6)
    c.add_program("h1", c.drift_borrower_program("h1", "s", registry,
                                                 attempts=3, cold_reads=3))
    c.add_program("h2", c.drift_borrower_program("h2", "s", registry,
                                                 attempts=3, cold_reads=3))
    c.add_program("owner", c.delayed(1e-3, c.recurate_program(
        "s", registry, expected_restores=10000, min_restores=1)))
    c.add_program("h3", c.delayed(4e-3, c.restore_program("h3", "s")))
    c.run(max_steps=30000)
    assert any(e.startswith("recurated:s:v1") for e in c.events), c.events
    entry = c.catalog.find("s")
    assert entry.state.load() == STATE_PUBLISHED
    assert entry.version == 1
    assert entry.regions.n_hot >= 3
    assert any(r["name"] == "s" and r["version"] == 1 for r in c.restored)
    return c


def scenario_predicted_order_restore(seed, device):
    """Predicted-order installs stay bit-identical: drift borrowers feed
    first-touch telemetry, then a restore drains its cold extents in the
    fitted model's order; a telemetry-free snapshot falls back to layout
    order and verifies too."""
    c = SimCluster(n_hosts=3, seed=seed, device=device)
    c.publish("s", 1.0, cold_pages=6)
    c.publish("fresh", 2.0, cold_pages=4)
    registry = HeatRegistry(clock=c.clock, half_life_s=1e6)
    c.add_program("h1", c.drift_borrower_program("h1", "s", registry,
                                                 attempts=2, cold_reads=4))
    c.add_program("h2", c.delayed(2e-3, c.predicted_restore_program(
        "h2", "s", registry)))
    c.add_program("h3", c.predicted_restore_program("h3", "fresh", registry))
    c.run(max_steps=30000)
    assert any(e.startswith("predicted_restore:h2:s:model")
               for e in c.events), c.events
    assert any(e.startswith("predicted_restore:h3:fresh:layout")
               for e in c.events), c.events
    assert any(r["name"] == "s" and r.get("predicted_order")
               for r in c.restored)
    return c


def scenario_recuration_owner_crash_mid_republish(seed, device):
    """The recurator dies between rebuilding the data regions and
    republishing the catalog entry: borrowers cold-start (never stale
    bytes), and a fresh publish of the same name recovers the entry."""
    c = SimCluster(n_hosts=2, seed=seed, device=device)
    regions0 = c.publish("s", 1.0)
    registry = HeatRegistry(clock=c.clock, half_life_s=1e6)
    hm = registry.map_for("s", 0, regions0.total_pages)
    hm.record(TouchEvent(pages=np.arange(regions0.total_pages),
                         kind="demand_fault"))
    hm.record(TouchEvent(pages=np.arange(regions0.total_pages),
                         kind="demand_fault"))
    hm.note_restore()
    hm.note_restore()
    c.add_program("recurator", c.recurate_program("s", registry, force=True,
                                                  expected_restores=10000))
    c.fault_plan.kill_after("recurator", "recurate:rebuilt")
    c.add_program("h1", c.borrower_program("h1", "s", attempts=3))
    c.run(max_steps=30000)
    assert "crashed:recurator" in c.events
    entry = c.catalog.find("s")
    assert entry is not None and entry.state.load() == STATE_TOMBSTONE
    assert entry.regions is None, "crashed mid-republish: no regions visible"
    rr = c.publish("s", 2.0)
    assert rr.version == 2
    c.add_program("h2", c.borrower_program("h2", "s", attempts=2))
    c.run(max_steps=60000)
    entry = c.catalog.find("s")
    assert entry.state.load() == STATE_PUBLISHED and entry.version == 2
    assert any(e.startswith("borrower_done:h2") for e in c.events)
    return c


def use_dedup_hash(c: SimCluster, hash_fn) -> None:
    """Make ``hash_fn`` the hash of ``c``'s two dedup stores (``None`` keeps
    FNV-1a-64).  Called before anything is stored."""
    if hash_fn is not None:
        for store in (c.pool.dedup_cxl, c.pool.dedup_rdma):
            assert not store._refs, "the store already holds pages"
            store.hash_fn = hash_fn


def scenario_dedup_owner_crash_mid_republish(seed, device, dedup_hash_fn=None):
    """Owner crash mid-republish of a dedup snapshot whose pages are shared
    with a live sibling: the rebuilt pages leak (still counted — I6), the
    shared pages survive, a borrower of the sibling keeps reading correct
    bytes, and a fresh publish heals the entry."""
    c = SimCluster(n_hosts=2, seed=seed, device=device)
    use_dedup_hash(c, dedup_hash_fn)
    c.publish("base", 1.0, dedup=True, distinct_hot=True,
              hot_pages=4, cold_pages=4)
    c.publish("var", 1.0, dedup=True, distinct_hot=True,
              hot_pages=4, cold_pages=4)
    store = c.pool.dedup_cxl
    assert store.logical_pages() == 2 * store.unique_pages(), \
        "setup: every hot page should be shared exactly twice"
    c.fault_plan.kill_after("owner", "publish:rebuilt")
    c.add_program("owner", c.publish_program("var", 2.0, dedup=True,
                                             distinct_hot=True,
                                             hot_pages=4, cold_pages=4))
    c.add_program("h1", c.borrower_program("h1", "base", attempts=3))
    c.run(max_steps=30000)
    assert "crashed:owner" in c.events
    assert "borrower_done:h1:3/3" in c.events, \
        "borrows of the sharing sibling must keep succeeding"
    entry = c.catalog.find("var")
    assert entry is not None and entry.state.load() == STATE_TOMBSTONE
    assert entry.regions is None, "crashed mid-republish: no regions visible"
    assert len(c.pending_regions) == 1 and c.pending_regions[0].dedup
    c.add_program("h2", c.restore_program("h2", "base"))
    c.run(max_steps=60000)
    assert any(r["name"] == "base" for r in c.restored)
    rr = c.publish("var", 3.0, dedup=True, distinct_hot=True)
    assert rr.version == 2 and rr.dedup
    c.add_program("h3", c.borrower_program("h3", "var", attempts=2))
    c.run(max_steps=90000)
    assert any(e.startswith("borrower_done:h3") for e in c.events)
    return c


def scenario_dedup_eviction_shared_with_live_borrower(seed, device, dedup_hash_fn=None):
    """The capacity clock demotes a dedup snapshot that shares pages with a
    snapshot a live borrower holds: the borrowed sibling keeps its hot set,
    the shared prefix survives the demotion, and every read is exact."""
    c = SimCluster(n_hosts=2, seed=seed, cxl_budget=14 * 4096, device=device)
    use_dedup_hash(c, dedup_hash_fn)
    c.publish("shared1", 1.0, dedup=True, distinct_hot=True,
              hot_pages=6, cold_pages=2)
    c.publish("shared2", 1.0, dedup=True, distinct_hot=True,
              hot_pages=4, cold_pages=2)
    assert c.pool.dedup_cxl.unique_pages() == 6, "prefix must be shared"

    def holder(host):
        rec = yield from c.borrow_program_steps(host, "shared2")
        assert rec is not None
        yield ("sleep", 0.02)           # hold across the capacity sweep
        view = c.pool.host_view(host)
        reader = SnapshotReader(rec.borrow.regions, view, c.pool.rdma)
        reader.invalidate_cxl()
        canonical = c.content["shared2"][rec.version].pages_matrix()
        for p in reader.hot_page_indices():
            assert torch.equal(reader.read_page(int(p)), canonical[int(p)]), \
                f"[seed={seed}] borrower read wrong bytes post-demotion"
            yield "holder:read"
        c.release(rec)
        yield "holder:released"

    c.add_program("h1", holder("h1"))
    c.add_program("publisher", c.delayed(0.005, c.publish_program(
        "big", 5.0, dedup=True, distinct_hot=True, hot_pages=8, cold_pages=2)))
    c.run(max_steps=60000)
    stats = c.master.capacity.budget.report()
    assert stats["demotions"] >= 1, f"clock never demoted: {stats}"
    assert "published:big:v0" in c.events
    entry = c.catalog.find("shared2")
    assert entry.state.load() == STATE_PUBLISHED
    assert entry.regions.n_hot == 4, "borrowed snapshot must keep its hot set"
    c.add_program("h2", c.restore_program("h2", "shared2"))
    c.run(max_steps=90000)
    assert any(r["name"] == "shared2" for r in c.restored)
    s1 = c.catalog.find("shared1")
    assert s1.regions.n_hot == 0, "victim should have been demoted to all-cold"
    assert c.pool.dedup_cxl.unique_pages() == 4
    return c


def scenario_rdma_flap_under_fanout_burst(seed, device):
    """A flapping RNIC during a 3-restore burst of one snapshot: the core
    FaultInjector times out the first 4 RDMA extent reads; every restore
    retries through and is bit-identical."""
    c = SimCluster(n_hosts=3, seed=seed, device=device)
    c.publish("snap", 4.0, hot_pages=4, cold_pages=8, zero_pages=2)
    inj = FaultInjector(clock=c.clock, seed=seed).fail_reads("rdma", 4)
    c.pool.attach_fault_injector(inj)
    for i, host in enumerate(("h1", "h2", "h3")):
        c.add_program(f"r{i}", c.restore_program(host, "snap"))
    c.run(max_steps=30000)
    assert len(c.restored) == 3
    assert sum(r["retries"] for r in c.restored) == 4
    assert inj.stats["injected_timeouts"] == 4
    assert c.catalog.find("snap").refcount.load() == 0
    return c


def scenario_cxl_poison_during_shared_restore(seed, device):
    """Per-page CXL poison on a shared dedup store page while two variants
    restore concurrently through checksum-verifying fused scatters: the
    poisoned install is detected, quarantined while it keeps failing, then
    repaired from the home tier — both restores end bit-identical and I6
    holds at every step.  Publishes through the fused sweep."""
    c = SimCluster(n_hosts=2, seed=seed, device=device)
    pf = make_fused_publish_fn()
    c.publish("va", 2.0, dedup=True, distinct_hot=True, publish_fn=pf,
              hot_pages=4, cold_pages=4)
    c.publish("vb", 2.0, dedup=True, distinct_hot=True, publish_fn=pf,
              hot_pages=4, cold_pages=4)
    store = c.pool.dedup_cxl
    off = min(store._hash_of)
    inj = FaultInjector(clock=c.clock, seed=seed).poison_reads(
        "cxl", 3, lo=off, hi=off + 4096)
    c.pool.attach_fault_injector(inj)
    sf = FusedScatter()
    c.add_program("r1", c.restore_program("h1", "va", scatter_fn=sf))
    c.add_program("r2", c.restore_program("h2", "vb", scatter_fn=sf))
    c.run(max_steps=30000)
    assert len(c.restored) == 2
    assert inj.stats["injected_poison"] == 3
    assert sum(r["repairs"] for r in c.restored) >= 1
    assert store.stats["quarantined"] >= 1
    assert store.stats["rematerialized"] >= 1
    assert not store.quarantined_offsets(), "repaired offset back in service"
    return c


def scenario_brownout_during_recuration(seed, device):
    """A CXL host-link brownout opens while the owner re-curates and a host
    restores: the owner-side re-curation completes, the restore degrades to
    the RDMA-only path instead of failing, and stays bit-identical."""
    c = SimCluster(n_hosts=3, seed=seed, device=device)
    c.publish("s", 1.0, cold_pages=4)
    registry = HeatRegistry(clock=c.clock, half_life_s=1e6)
    c.add_program("h1", c.drift_borrower_program("h1", "s", registry,
                                                 attempts=3, cold_reads=3))
    c.add_program("owner", c.delayed(1e-3, c.recurate_program(
        "s", registry, expected_restores=10000, min_restores=1)))
    c.add_program("h3", c.delayed(4e-3, c.restore_program("h3", "s")))
    inj = FaultInjector(clock=c.clock, seed=seed).brownout(
        "cxl", start_s=3.5e-3, duration_s=10.0)
    c.pool.attach_fault_injector(inj)
    c.run(max_steps=30000)
    assert any(e.startswith("recurated:s:v1") for e in c.events), c.events
    assert any(e.startswith("degraded_restore:h3:s") for e in c.events), c.events
    degraded = [r for r in c.restored if r["host"] == "h3"]
    assert degraded and degraded[0]["degraded"]
    assert inj.stats["brownout_rejections"] >= 1
    return c


SCENARIOS: Dict[str, Callable] = {
    "steady_borrow_release": scenario_steady_borrow_release,
    "rdma_flap_under_fanout_burst": scenario_rdma_flap_under_fanout_burst,
    "cxl_poison_during_shared_restore": scenario_cxl_poison_during_shared_restore,
    "brownout_during_recuration": scenario_brownout_during_recuration,
    "dedup_owner_crash_mid_republish": scenario_dedup_owner_crash_mid_republish,
    "dedup_eviction_shared_with_live_borrower":
        scenario_dedup_eviction_shared_with_live_borrower,
    "drift_recuration_feedback": scenario_drift_recuration_feedback,
    "predicted_order_restore": scenario_predicted_order_restore,
    "recuration_owner_crash_mid_republish": scenario_recuration_owner_crash_mid_republish,
    "owner_update_vs_borrowers": scenario_owner_update_vs_borrowers,
    "doomed_borrow_interleaving": scenario_doomed_borrow_interleaving,
    "livelock_when_fix_reverted": scenario_livelock_when_fix_reverted,
    "host_crash_mid_borrow": scenario_host_crash_mid_borrow,
    "host_crash_holding_borrow": scenario_host_crash_holding_borrow,
    "owner_crash_between_tombstone_and_republish":
        scenario_owner_crash_between_tombstone_and_republish,
    "master_failover_basic": scenario_master_failover_basic,
    "master_failover_races_8_hosts": scenario_master_failover_races_8_hosts,
    "lease_expiry_during_gc": scenario_lease_expiry_during_gc,
    "rdma_extent_timeout_retry": scenario_rdma_extent_timeout_retry,
    "rdma_timeout_exhausts_retries": scenario_rdma_timeout_exhausts_retries,
    "batched_vs_perpage_restore_under_updates":
        scenario_batched_vs_perpage_restore_under_updates,
    "eviction_under_borrows": scenario_eviction_under_borrows,
    "catalog_churn": scenario_catalog_churn,
    "delete_during_update_drain": scenario_delete_during_update_drain,
    "owner_crash_after_freeing_old": scenario_owner_crash_after_freeing_old,
    "lease_fallback": scenario_lease_fallback,
}

#: the dedup scenarios, which take ``dedup_hash_fn``
DEDUP_SCENARIOS = ("dedup_owner_crash_mid_republish",
                   "dedup_eviction_shared_with_live_borrower")


def scenario_seed(name: str, base: int = 0) -> int:
    """The seed the scenario matrix runs ``name`` at (base 0 by default)."""
    return base + 17 * (sorted(SCENARIOS).index(name) + 1)


#: the multi-seed sets: (name, seed(offset)) for offsets 0, 1, 2
MULTI_SEED = {
    "drift": (("drift_recuration_feedback", lambda o, base=0: base + 101 * o + 7),
              ("recuration_owner_crash_mid_republish", lambda o, base=0: base + 101 * o + 8)),
    "dedup": (("dedup_owner_crash_mid_republish", lambda o, base=0: base + 131 * o + 11),
              ("dedup_eviction_shared_with_live_borrower",
               lambda o, base=0: base + 131 * o + 12)),
}


def different_seeds_cluster(seed, device):
    """The interleaving-randomization check's cluster: an owner update racing
    three borrowers under the random scheduler."""
    c = SimCluster(n_hosts=3, seed=seed, device=device)
    c.publish("snap", 1.0)
    c.add_program("owner", c.publish_program("snap", 2.0))
    for h in ("h1", "h2", "h3"):
        c.add_program(h, c.borrower_program(h, "snap", attempts=3))
    c.run()
    return c


# ---------------------------------------------------------------------------
# multi-pod scenarios (I7 / I8)
# ---------------------------------------------------------------------------

def pod_cluster(seed, device, n_pods=2, ports_per_pod=None, hosts=()):
    c = SimCluster(n_hosts=max(1, len(hosts)), seed=seed, n_pods=n_pods,
                   ports_per_pod=ports_per_pod, schedule="round_robin", device=device)
    for host, pod in hosts:
        c.group.assign_host(host, pod)
    return c


def scenario_replicated_publish_and_update(seed, device):
    """k=2 publish, then an update racing borrowers homed on three pods: the
    lockstep barrier means no step observes mixed PUBLISHED versions."""
    c = pod_cluster(seed, device, n_pods=3, hosts=[("h1", 0), ("h2", 1), ("h3", 2)])
    c.add_program("owner", c.group_publish_program("s", 1.0, pods=[0, 1]))
    c.run()
    assert c.replicas.replica_pods("s") == [0, 1]
    c.add_program("owner2", c.group_publish_program("s", 2.0))
    for h in ("h1", "h2", "h3"):
        c.add_program(h, c.group_borrower_program(h, "s", attempts=3))
    c.run()
    assert c.replicas.version_of("s") == 1
    for pid in (0, 1):
        entry = c.pods[pid].catalog.find("s")
        assert entry.version == 1 and entry.state.load() == STATE_PUBLISHED
    assert any("barrier" in lbl for _s, _n, lbl in c.trace)
    done = [e for e in c.events if e.startswith("group_borrower_done")]
    assert len(done) == 3
    assert c.replicas.stats["routed_interpod"] > 0
    assert c.router.stats["interpod_reads"] > 0
    return c


def scenario_replica_delete_drain_window(seed, device):
    """Group delete while a borrow is live on one replica: every replica
    tombstones first, then the delete polls GC until the straggler
    releases."""
    c = pod_cluster(seed, device, hosts=[("h1", 1)])
    c.add_program("owner", c.group_publish_program("s", 1.0, pods=[0, 1]))
    c.run()

    def holder():
        rec = yield from c.borrow_program_steps("h1", "s", pod=1)
        assert rec is not None
        yield "held"
        yield ("sleep", 3e-3)       # keep the pin open across the delete
        c.release(rec)
        yield "released"

    c.add_program("h1", holder())
    c.add_program("deleter", c.delayed(
        1e-4, c.group_delete_program("s", drain_limit=None)))
    c.run(max_steps=40000)
    assert "gdel_done:s" in c.events
    assert c.replicas.names() == []
    assert any(":gc_pending" in lbl for _s, n, lbl in c.trace
               if n == "deleter"), "delete never waited on a live borrow"
    for pid in (0, 1):
        entry = c.pods[pid].catalog.find("s")
        assert entry is None or entry.state.load() != STATE_PUBLISHED
    return c


def scenario_pod_link_partition(seed, device):
    """A data-plane partition between a host's home pod and the only replica
    pod: routed reads refuse cleanly (cold start, never stale bytes);
    healing the link restores inter-pod routing."""
    c = pod_cluster(seed, device, hosts=[("h1", 1), ("h2", 1)])
    c.add_program("owner", c.group_publish_program("s", 1.0, pods=[0]))
    c.run()
    c.add_program("cut", c.partition_program(1, 0, delay_s=1.5e-4))
    c.add_program("h1", c.group_borrower_program("h1", "s", attempts=4,
                                                 pause_s=1e-4))
    c.run(max_steps=20000)
    assert "partition:1-0" in c.events
    assert c.replicas.stats["routed_none"] > 0, \
        "partitioned host should have fallen back to cold start"
    assert any(e.startswith("cold_start:h1") for e in c.events)
    before = c.replicas.stats["routed_interpod"]
    c.add_program("heal", c.partition_program(1, 0, delay_s=0.0, up=True))
    c.add_program("h2", c.delayed(
        1e-4, c.group_borrower_program("h2", "s", attempts=2)))
    c.run(max_steps=30000)
    assert c.replicas.stats["routed_interpod"] > before
    assert "group_borrower_done:h2:2/2" in c.events
    return c


def scenario_owner_pod_loss_promote(seed, device):
    """Losing a pod promotes surviving replicas (a routing change, not a
    copy); single-replica names on the dead pod are reported lost."""
    c = pod_cluster(seed, device, hosts=[("h1", 0), ("h2", 1)])
    c.add_program("owner_s", c.group_publish_program("s", 1.0, pods=[0, 1]))
    c.add_program("owner_solo", c.group_publish_program("solo", 3.0, pods=[0]))
    c.run()
    c.add_program("loss", c.pod_loss_program(0, delay_s=1.5e-4))
    c.add_program("h1", c.group_borrower_program("h1", "s", attempts=4,
                                                 pause_s=1e-4))
    c.add_program("h2", c.group_borrower_program("h2", "solo", attempts=4,
                                                 pause_s=1e-4))
    c.run(max_steps=30000)
    assert "pod_lost:0" in c.events
    assert "replica_lost:solo" in c.events
    assert c.replicas.replica_pods("s") == [1]
    assert c.replicas.stats["promotions"] >= 2
    assert any(e.startswith("cold_start:h2") for e in c.events)
    assert "group_borrower_done:h1:4/4" in c.events
    return c


def scenario_port_starvation_burst(seed, device):
    """5 hosts against a 2-port MHD: beyond-limit borrows fall through to
    inter-pod RDMA instead of queueing forever; peak attach never exceeds
    the port limit."""
    hosts = [(f"h{i}", 0) for i in range(1, 6)]
    c = pod_cluster(seed, device, ports_per_pod=2, hosts=hosts)
    c.add_program("owner", c.group_publish_program("s", 1.0, pods=[0, 1]))
    c.run()
    for h, _pod in hosts:
        c.add_program(h, c.group_borrower_program(h, "s", attempts=3))
    c.run(max_steps=40000)
    done = [e for e in c.events if e.startswith("group_borrower_done")]
    assert sorted(done) == sorted(
        f"group_borrower_done:h{i}:3/3" for i in range(1, 6))
    ports = c.pods[0].ports
    assert ports.stats["peak"] <= 2, "port limit was exceeded"
    assert ports.stats["fallthrough"] > 0, "burst never overflowed to the fabric"
    assert c.replicas.stats["routed_local"] > 0
    assert c.replicas.stats["routed_interpod"] > 0
    return c


def scenario_migration_break_even(seed, device):
    """Migration is economics-gated: a cold name (1 expected read) stays put;
    a hot one (10k expected reads) replicates to the demand pod at the same
    version, after which that pod's hosts borrow locally."""
    c = pod_cluster(seed, device, ports_per_pod=4, hosts=[("h1", 1), ("h2", 1)])
    c.add_program("owner", c.group_publish_program("s", 1.0, pods=[0]))
    c.run()
    c.add_program("mig_cold", c.migrate_program("s", 1, expected_reads=1))
    c.run()
    assert c.migrator.stats["skipped_uneconomic"] == 1
    assert c.replicas.replica_pods("s") == [0]
    c.add_program("mig_hot", c.migrate_program("s", 1, expected_reads=10000))
    c.run()
    assert c.migrator.stats["migrated"] == 1
    assert c.replicas.replica_pods("s") == [0, 1]
    assert c.replicas.version_of("s") == 0
    local_before = c.replicas.stats["routed_local"]
    c.add_program("h1", c.group_borrower_program("h1", "s", attempts=2))
    c.run(max_steps=20000)
    assert c.replicas.stats["routed_local"] > local_before
    assert "group_borrower_done:h1:2/2" in c.events
    return c


TOPOLOGY_SCENARIOS: Dict[str, Callable] = {
    "replicated_publish_and_update": scenario_replicated_publish_and_update,
    "replica_delete_drain_window": scenario_replica_delete_drain_window,
    "pod_link_partition": scenario_pod_link_partition,
    "owner_pod_loss_promote": scenario_owner_pod_loss_promote,
    "port_starvation_burst": scenario_port_starvation_burst,
    "migration_break_even": scenario_migration_break_even,
}


def topology_seed(name: str, offset: int = 0, base: int = 0) -> int:
    """The seed the multi-pod matrix runs ``name`` at, for seed offset 0–2."""
    return base + 100 * offset + 7 * (sorted(TOPOLOGY_SCENARIOS).index(name) + 1)


# ---------------------------------------------------------------------------
# cell (6): the multi-pod topology at one image
# ---------------------------------------------------------------------------

def rewrite_pages(image: StateImage, pages: np.ndarray, seed: int) -> StateImage:
    """A copy of ``image`` (on its device) with ``pages`` rewritten to seeded
    random bytes, each page's first byte odd so no page turns zero: the
    update keeps every page's class (zero, hot or cold)."""
    g = torch.Generator(device=image.device)
    g.manual_seed(seed)
    out = StateImage(image.manifest, image.buf.clone())
    idx = torch.from_numpy(np.asarray(pages, dtype=np.int64)).to(image.device)
    new = torch.randint(0, 256, (idx.numel(), PAGE), dtype=torch.uint8, generator=g,
                        device=image.device)
    new[:, 0] |= 1
    out.pages_matrix()[idx] = new
    return out


def timed(gen, walls: dict, key: str, sync=None):
    """``gen`` as a program whose own steps are timed: ``walls[key]`` holds
    the wall seconds spent inside its steps so far (others' steps excluded),
    each step closed by ``sync`` when given."""
    walls[key] = 0.0
    try:
        while True:
            t0 = time.perf_counter()
            try:
                item = next(gen)
            except StopIteration as stop:
                walls[key] += time.perf_counter() - t0
                return stop.value
            if sync is not None:
                sync()
            walls[key] += time.perf_counter() - t0
            yield item
    finally:
        gen.close()


def run_to_end(c: SimCluster) -> None:
    """Run every program of ``c`` to its end (no step budget), and check
    that none is left."""
    c.run(max_steps=10 ** 12)
    left = [p.name for p in c._programs.values() if not p.done]
    assert not left, f"programs left running: {left}"


def topology_cell(seed: int, device, v0: Tuple[StateImage, np.ndarray],
                  v1: Tuple[StateImage, np.ndarray], read_pages: int,
                  cxl_capacity: int, rdma_capacity: int, publish_fn=None,
                  scatter_fn=None, name: str = "cell") -> Tuple[SimCluster, dict]:
    """Cell (6)'s programs on ``SimCluster(n_pods=3, ports_per_pod=2,
    schedule="round_robin")``, I1–I8 checked after every step:

    1. a group publish of ``v0`` to pods [0, 1];
    2. an update to ``v1`` (started 100 µs of simulated time in, once every
       borrow has landed) racing 9 ``group_borrower_program``s, 3 homed on
       each pod, 2 attempts of ``read_pages`` hot pages each, and
    3. a full ``restore_program`` on pod 0 through ``scatter_fn``;
    4. ``migrate_program`` to pod 2 at 10x the break-even reads,
       ``drop_source=True``;
    5. a partition of pods 0–2 with one pod-0 borrower of 16 pages under
       it, which must read from pod 1 (pod 2, the least-served replica, is
       cut off), then its heal and a second pod-0 borrower, which must read
       from pod 2;
    6. the loss of pod 1 and its promotion;
    7. a group delete; the dead pod's own master then frees what it held
       (delete + gc), as on its return.

    ``v0``/``v1`` are ``(image, working_set)`` pairs on ``device`` of one
    manifest; every pod master publishes through ``publish_fn``.  Asserts
    bit-identity (inside the programs, and of the migrated replica), the
    routing counters, the promotion and every pod's free lists back to the
    start; returns the cluster and a report (walls of the group writes, the
    migration, the restore and each borrower spent inside their own steps,
    and of the invariant checks; steps; ``checks_run``; modeled inter-pod
    seconds; the routing stats)."""
    c = SimCluster(n_hosts=1, seed=seed, n_pods=3, ports_per_pod=2,
                   schedule="round_robin", cxl_capacity=cxl_capacity,
                   rdma_capacity=rdma_capacity, device=device)
    for pod in c.pods:
        pod.master.publish_fn = publish_fn
    start = [(p.pool.cxl.free_list(), p.pool.rdma.free_list()) for p in c.pods]
    hosts = [(f"h{p}{k}", p) for p in range(3) for k in "abc"]
    for host, pid in hosts:
        c.group.assign_host(host, pid)
    c.group.assign_host("r0", 0)
    c.group.assign_host("p0", 0)
    c.group.assign_host("p0h", 0)
    sync = torch.cuda.synchronize if c.device.type == "cuda" else None
    walls: dict = {"checks": 0.0}
    rep: dict = {"walls_s": walls}
    check_all = c.checker.check_all

    def timed_checks():          # the I1-I8 sweep after every step, timed
        t0 = time.perf_counter()
        check_all()
        walls["checks"] += time.perf_counter() - t0

    c.checker.check_all = timed_checks

    # 1. v0 on pods 0 and 1
    c.add_program("publish", timed(c.group_publish_program(name, 0.0, pods=[0, 1], image=v0),
                                   walls, "publish_v0", sync))
    run_to_end(c)
    assert c.replicas.replica_pods(name) == [0, 1]
    # 2 + 3. the update under 9 routed borrowers and a full restore on pod 0
    c.add_program("restore", timed(c.restore_program("r0", name, scatter_fn=scatter_fn),
                                   walls, "restore", sync))
    for host, _pid in hosts:
        c.add_program(host, timed(c.group_borrower_program(host, name, attempts=2,
                                                           read_pages=read_pages),
                                  walls, f"borrower_{host}", sync))
    c.add_program("update", c.delayed(1e-4, timed(
        c.group_publish_program(name, 1.0, image=v1), walls, "update_v1", sync)))
    run_to_end(c)
    assert c.replicas.version_of(name) == 1
    assert [r["host"] for r in c.restored] == ["r0"], c.restored
    done = sorted(e for e in c.events if e.startswith("group_borrower_done"))
    assert len(done) == 9, done
    drained = [lbl for _s, prog, lbl in c.trace
               if prog == "update" and lbl.endswith(":draining")]
    assert drained, "the update never drained under a borrow"
    rep["update_drain_polls"] = len(drained)
    rep["borrowers"] = done
    rep["restored"] = [{k: r[k] for k in ("host", "version", "retries", "repairs")}
                       for r in c.restored]
    # 4. migrate to pod 2 past break-even, retiring the least-demanded source
    econ = c.migrator.economics_for(name, expected_reads=1)
    reads = int(10 * econ["break_even_reads"]) + 1
    c.add_program("migrate", timed(c.migrate_program(name, 2, expected_reads=reads,
                                                     drop_source=True),
                                   walls, "migrate", sync))
    run_to_end(c)
    mig = [lbl for _s, prog, lbl in c.trace if prog == "migrate"]
    assert c.migrator.stats["migrated"] == 1 and c.migrator.stats["dropped"] == 1, \
        (c.migrator.stats, econ, reads, mig[:12], mig[-12:])
    reps = c.replicas.replica_pods(name)
    assert 2 in reps and len(reps) == 2, reps
    migrated = c.pods[2].catalog.find(name)
    img2 = reconstruct_image(c.pods[2].pool, migrated.regions)
    assert migrated.version == 1 and torch.equal(img2.buf, v1[0].buf), \
        "the migrated replica is not bit-identical to version 1"
    del img2
    rep["migration"] = {"expected_reads": reads,
                        "break_even_reads": econ["break_even_reads"],
                        "replicas_after": reps}
    # 5. partition pods 0 and 2 under a pod-0 borrower, then heal.  Pod 2,
    # the least-served replica, is where the router sends p0 with the link
    # up; under the cut p0 must read from pod 1, after the heal from pod 2.
    served = c.replicas.served[name]
    assert served.get(2, 0) < served[1], served
    c.add_program("cut", c.partition_program(0, 2, delay_s=0.0))
    c.add_program("p0", c.delayed(1e-5, c.group_borrower_program("p0", name, attempts=1,
                                                                   read_pages=16)))
    c.add_program("heal", c.partition_program(0, 2, delay_s=5e-3, up=True))
    run_to_end(c)
    ev = c.events
    assert "group_borrower_done:p0:1/1" in ev, ev[-6:]
    assert ev.index("partition:0-2") < ev.index("group_borrower_done:p0:1/1") \
        < ev.index("heal:0-2"), ev[-6:]
    assert ("p0", 1) in c.router._arbiters and ("p0", 2) not in c.router._arbiters, \
        "p0 did not read from pod 1 under the cut"
    c.add_program("p0h", c.group_borrower_program("p0h", name, attempts=1, read_pages=16))
    run_to_end(c)
    assert "group_borrower_done:p0h:1/1" in c.events
    assert ("p0h", 2) in c.router._arbiters and ("p0h", 1) not in c.router._arbiters, \
        "p0h did not read from pod 2 after the heal"
    rep["partition"] = {"under_cut": "pod 1", "after_heal": "pod 2"}
    # 6. pod 1 lost, its replica promoted away
    held_by_1 = 1 in c.replicas.replica_pods(name)
    c.add_program("loss", c.pod_loss_program(1, delay_s=0.0))
    run_to_end(c)
    assert "pod_lost:1" in c.events and 1 not in c.replicas.replica_pods(name)
    assert c.replicas.stats["promotions"] == int(held_by_1)
    # 7. group delete, then the dead pod's own leftovers
    c.add_program("delete", c.group_delete_program(name))
    run_to_end(c)
    assert f"gdel_done:{name}" in c.events and c.replicas.names() == []
    if c.pods[1].catalog.find(name) is not None:
        c.pods[1].master.delete(name)
    for pod, (cxl, rdma) in zip(c.pods, start):
        assert pod.pool.cxl.free_list() == cxl and pod.pool.rdma.free_list() == rdma, \
            f"pod {pod.pod_id}: free lists not back to the start"
    stats = dict(c.replicas.stats)
    assert stats["routed_local"] > 0 and stats["routed_interpod"] > 0, stats
    assert stats["port_fallthrough"] > 0 and c.router.stats["interpod_reads"] > 0, stats
    for pid in (0, 1):
        assert c.pods[pid].ports.stats["fallthrough"] > 0, (pid, c.pods[pid].ports.stats)
        assert c.pods[pid].ports.stats["peak"] <= 2
    rep.update(
        steps=c.step_no, checks_run=c.checker.checks_run, replica_stats=stats,
        router_stats=dict(c.router.stats), migrator_stats=dict(c.migrator.stats),
        fallthrough_by_pod=[p.ports.stats["fallthrough"] for p in c.pods],
        promoted_pod1_replica=held_by_1, modeled_interpod_s=interpod_seconds(c),
        borrowers_s=sum(v for k, v in walls.items() if k.startswith("borrower_")))
    return c, rep


def interpod_seconds(c: SimCluster) -> float:
    """Modeled inter-pod seconds of the reads the router charged.  Each is
    one page in one op, and no stream registers on the router's arbiters,
    so each charge is ``INTER_POD_COST.xfer_time_pipelined(PAGE, 1)``."""
    return c.router.stats["interpod_reads"] * INTER_POD_COST.xfer_time_pipelined(PAGE, 1)


# ---------------------------------------------------------------------------
# the card against the CPU
# ---------------------------------------------------------------------------

def outcome(c: SimCluster) -> dict:
    """What two runs of one scenario must agree on: trace, events, restored
    records (ledgers included), checks run, each pod's catalog words (with
    the checksum tables of its regions), free lists and dedup store
    refcounts and stats, and the fault injector's stats."""
    return {
        "trace": list(c.trace), "events": list(c.events), "restored": list(c.restored),
        "checks_run": c.checker.checks_run,
        "catalogs": [_words(interop.catalog_state(p.catalog)) for p in c.pods],
        "free": [(p.pool.cxl.free_list(), p.pool.rdma.free_list()) for p in c.pods],
        "stores": [[(dict(st._refs), dict(st.stats)) for st in (p.pool.dedup_cxl,
                                                                  p.pool.dedup_rdma)]
                   for p in c.pods],
        "injector": (dict(c.pool.fault_injector.stats)
                     if c.pool.fault_injector is not None else None),
    }


def _words(state: dict) -> dict:
    """A catalog state in a form ``==`` compares: each regions pair's
    checksum table (what the publish wrote, ``fused_publish`` on the card)
    as its bytes."""
    def regions(pair):
        if pair is None:
            return None
        return pair[0], None if pair[1] is None else pair[1].tobytes()

    return {"capacity": state["capacity"],
            "entries": [dict(e, regions=regions(e["regions"])) for e in state["entries"]]}


def cuda_parity(fn: Callable, seed: int, **kw) -> Tuple[SimCluster, float, float]:
    """Run ``fn(seed, device)`` on the CPU and on the card; raise unless the
    two outcomes are equal.  Returns the CUDA cluster and the two walls."""
    t0 = time.perf_counter()
    cpu = outcome(fn(seed, "cpu", **kw))
    t1 = time.perf_counter()
    c = fn(seed, "cuda", **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gpu = outcome(c)
    for key in cpu:
        if cpu[key] != gpu[key]:
            raise AssertionError(f"{fn.__name__}(seed={seed}): {key} differs between "
                                 f"cuda and cpu")
    return c, t1 - t0, t2 - t1

