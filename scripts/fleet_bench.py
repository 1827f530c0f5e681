#!/usr/bin/env python3
"""Fleet-serving benchmark on the PyTorch port: traffic in, tail out.

    PYTHONPATH=src python scripts/fleet_bench.py [--quick] [--multipod] [--device cuda|cpu]

The port's twin of ``benchmarks/fleet_bench.py``, with the same seeds, the
same numpy byte streams and the same steps, so its JSON equals the JAX
package's committed ``experiments/fleet_bench*.json`` key for key:

1. a real pod is built on ``device`` — one dedup variant snapshot per
   function type published through ``PoolMaster`` and the fused publish
   sweep (``kernels.make_fused_publish_fn()``: one kernel launch a publish
   on a CUDA pool), admission
   priced by ``DedupStore.probe_new_bytes`` and residency audited with
   ``exclusive_cxl_bytes``;
2. each snapshot is profiled through a ``SnapshotReader`` into a
   ``RestoreProfile`` that must reproduce ``modeled_concurrent_restore_s``
   exactly;
3. a sample of variants is restored through the serving path and compared
   with its image (``torch.equal``);
4. a seeded heavy-tailed trace drives the ``FleetDriver`` under each
   placement policy (``--multipod``: the single-pod, no-replication and
   replicated tiers of a multi-pod fleet).

Modeled seconds are the paper's cost model, not device times.  Results go
to ``experiments/torch/fleet_bench{,_quick,_multipod,_multipod_quick}.json``.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (  # noqa: E402
    HierarchicalPool,
    Instance,
    PoolMaster,
    RestoreEngine,
    SnapshotReader,
    StateImage,
)
from repro_torch.core.pagestore import PAGE_SIZE  # noqa: E402
from repro_torch.core.snapshot import exclusive_cxl_bytes  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    POLICIES,
    FleetDriver,
    FleetTopology,
    QueueAutoscaler,
    generate_trace,
    plan_balanced,
    plan_replicated,
    plan_single,
    profile_reader,
    synthesize_fleet,
)
from repro_torch.fleet.driver import float_mean  # noqa: E402
from repro_torch.kernels import make_fused_publish_fn  # noqa: E402
from repro_torch.serve.strategies import modeled_concurrent_restore_s  # noqa: E402
from repro_torch.sim.clock import VirtualClock  # noqa: E402

OUT = ROOT / "experiments" / "torch"
SEED = int(os.environ.get("AQUIFER_SIM_SEED", "0"))


def _timed(walls: dict, name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds stored as ``walls[name]``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    walls[name] = time.perf_counter() - t0
    return out


def make_pod(device, n_bases, n_types, hot_pages, delta_pages,
             cxl_capacity=1 << 30, rdma_capacity=1 << 30):
    """The dedup pod the fleet publishes into, with the reference's budget
    (dedup keeps a base group's shared pages once, so the pod fits; the
    margin still makes the capacity manager account every publish).  Every
    publish runs the fused sweep: one launch of its kernel on a CUDA pool,
    its plain version on a CPU one."""
    pool = HierarchicalPool(cxl_capacity=cxl_capacity, rdma_capacity=rdma_capacity,
                            device=device)
    budget = (n_bases * hot_pages + n_types * (delta_pages + 4)) * PAGE_SIZE * 2
    return pool, PoolMaster(pool, cxl_budget=budget, dedup=True,
                            publish_fn=make_fused_publish_fn())


def build_pod(fleet, hot_pages, cold_pages, zero_pages, delta_pages,
              seed=SEED, device="cuda"):
    """Publish one dedup variant snapshot per function type: variants of a
    base group share that group's base hot pages and differ in
    ``delta_pages`` private rows plus a private cold arena.  The bytes are
    the reference's numpy stream, moved to ``device``."""
    rng = np.random.default_rng(seed)
    n_bases = max(f.base_group for f in fleet) + 1
    bases = [rng.integers(1, 255, hot_pages * PAGE_SIZE,
                          dtype=np.int64).astype(np.uint8)
             for _ in range(n_bases)]
    pool, master = make_pod(device, n_bases, len(fleet), hot_pages, delta_pages)
    images, probes = {}, []
    for f in fleet:
        w = bases[f.base_group].copy()
        lo = (f.fn_id * delta_pages) % hot_pages
        for d in range(delta_pages):
            p = (lo + d) % hot_pages
            w[p * PAGE_SIZE:(p + 1) * PAGE_SIZE] = \
                rng.integers(1, 255, PAGE_SIZE).astype(np.uint8)
        img = StateImage.build({
            "w": w,
            "cold": rng.integers(1, 255, cold_pages * PAGE_SIZE).astype(np.uint8),
            "z": np.zeros(zero_pages * PAGE_SIZE, np.uint8),
        }, device=pool.device)
        ws = list(range(img.manifest.by_name()["w"].page_count))
        # marginal CXL bytes this publish will newly allocate (admission's
        # ground truth): first variant of a group pays its base, the rest
        # pay ~delta_pages
        probes.append(int(pool.dedup_cxl.probe_new_bytes(img.pages_matrix()[:len(ws)])))
        master.publish(f.name, img, ws)
        images[f.fn_id] = img
    return pool, master, images, probes


def profile_pod(pool, master, fleet):
    """One RestoreProfile per published snapshot, with its shared-base
    fraction taken from the dedup store's refcounts (exclusive_cxl_bytes),
    and an exactness check against the analytic restore model.  No host
    view outlives its function: each holds a shadow of the CXL arena."""
    profiles = {}
    max_err = 0.0
    for f in fleet:
        entry = master.catalog.find(f.name)
        assert entry is not None and entry.regions is not None, \
            f"{f.name} not resident"
        r = entry.regions
        reader = SnapshotReader(r, pool.host_view(f"prof-{f.name}"), pool.rdma)
        hot_bytes = r.n_hot * PAGE_SIZE
        excl = exclusive_cxl_bytes(pool, r)
        prof = profile_reader(reader,
                              shared_base_bytes=max(0, hot_bytes - excl),
                              exclusive_bytes=excl)
        for conc in (1, 4):
            want = modeled_concurrent_restore_s(reader, conc)
            got = prof.cold_start_s(conc)
            max_err = max(max_err, abs(want - got))
            assert math.isclose(want, got, rel_tol=1e-12), \
                f"profile departs from restore model: {want} vs {got}"
        profiles[f.fn_id] = prof
        del reader
    return profiles, max_err


def sample_ids(fleet, n_sample):
    """The deterministic restore sample: ``n_sample`` types spread evenly."""
    return [int(i) for i in np.linspace(0, len(fleet) - 1, n_sample).astype(int)]


def verify_restores(pool, master, images, fleet, n_sample):
    """Serving-path restore + byte-compare for a deterministic sample."""
    ok = []
    for i in sample_ids(fleet, n_sample):
        f = fleet[i]
        borrow = master.catalog.borrow(f.name)
        assert borrow is not None
        try:
            reader = SnapshotReader(borrow.regions,
                                    pool.host_view(f"v-{f.name}"), pool.rdma)
            reader.invalidate_cxl()
            inst = Instance(StateImage.empty_like(images[f.fn_id].manifest,
                                                  device=pool.device))
            RestoreEngine(reader, inst, rdma_engine=None).install_all_sync()
            ok.append(bool(inst.all_present() and
                           torch.equal(inst.image.buf, images[f.fn_id].buf)))
            del reader, inst
        finally:
            borrow.release()
    return bool(all(ok)), len(ok)


def drive(fleet, profiles, trace, policy, n_hosts, slots, max_hosts):
    d = FleetDriver(fleet, profiles, policy=policy, seed=SEED,
                    n_hosts=n_hosts, slots_per_host=slots,
                    clock=VirtualClock(),
                    autoscaler=QueueAutoscaler(min_hosts=n_hosts,
                                               max_hosts=max_hosts))
    return d.run(trace)


def same_result(r1, r2) -> bool:
    return bool(np.array_equal(r1.host, r2.host)
                and np.array_equal(r1.mode, r2.mode)
                and np.array_equal(r1.ready_s, r2.ready_s, equal_nan=True)
                and np.array_equal(r1.done_s, r2.done_s, equal_nan=True))


# -- a pod at the card's scale ------------------------------------------------
# The bench's pod is small by design (it extrapolates its profiles 1,024x).
# The scale pod keeps the full configuration's fleet and multiplies every
# variant's pages by SCALE_X; its bytes come from torch generators on the
# pool's device, seeded per base group and per function type, so any
# variant's image can be made again from the seed alone.

SCALE_X = 64                      # pages per variant over the full configuration's


def _gen_seed(seed: int, kind: int, i: int) -> int:
    return int(np.random.SeedSequence((seed, kind, i)).generate_state(1, np.uint64)[0] >> 1)


def scale_base(group: int, hot_pages: int, seed: int, device) -> torch.Tensor:
    """Base group ``group``'s hot bytes (non-zero), made on ``device``."""
    g = torch.Generator(device=device).manual_seed(_gen_seed(seed, 0, group))
    return torch.randint(1, 255, (hot_pages * PAGE_SIZE,), generator=g,
                         dtype=torch.uint8, device=device)


def scale_image(f, hot_pages, cold_pages, zero_pages, delta_pages, seed, device,
                base=None) -> StateImage:
    """Function type ``f``'s image: its base group's hot pages with
    ``delta_pages`` rows of its own at the bench's positions, a private cold
    arena and a zero arena, all made from ``seed`` on ``device``."""
    device = torch.device(device)
    w = (scale_base(f.base_group, hot_pages, seed, device) if base is None
         else base).clone()
    g = torch.Generator(device=device).manual_seed(_gen_seed(seed, 1, f.fn_id))
    lo = (f.fn_id * delta_pages) % hot_pages
    rows = (lo + torch.arange(delta_pages, device=device)) % hot_pages
    w.view(hot_pages, PAGE_SIZE)[rows] = torch.randint(
        1, 255, (delta_pages, PAGE_SIZE), generator=g, dtype=torch.uint8, device=device)
    cold = torch.randint(1, 255, (cold_pages * PAGE_SIZE,), generator=g,
                         dtype=torch.uint8, device=device)
    zero = torch.zeros(zero_pages * PAGE_SIZE, dtype=torch.uint8, device=device)
    return StateImage.build({"w": w, "cold": cold, "z": zero}, device=device)


def build_scale_pod(fleet, hot_pages, cold_pages, zero_pages, delta_pages,
                    seed=SEED, device="cuda"):
    """Publish every function type's scale image into one dedup pod; no
    image outlives its publish.  Returns ``(pool, master, publish_walls)``."""
    n_bases = max(f.base_group for f in fleet) + 1
    meta_pages = 1 + -(-(hot_pages + cold_pages + zero_pages) * 8 // PAGE_SIZE)
    cxl = (n_bases * hot_pages + len(fleet) * (delta_pages + meta_pages)) * PAGE_SIZE
    rdma = len(fleet) * cold_pages * PAGE_SIZE
    pool, master = make_pod(device, n_bases, len(fleet), hot_pages, delta_pages,
                            cxl_capacity=-(-cxl * 5 // 4 // PAGE_SIZE) * PAGE_SIZE,
                            rdma_capacity=-(-rdma * 5 // 4 // PAGE_SIZE) * PAGE_SIZE)
    bases = {}
    walls = []
    for f in fleet:
        if f.base_group not in bases:
            bases[f.base_group] = scale_base(f.base_group, hot_pages, seed, pool.device)
        img = scale_image(f, hot_pages, cold_pages, zero_pages, delta_pages, seed,
                          pool.device, base=bases[f.base_group])
        if pool.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        master.publish(f.name, img, np.arange(hot_pages))
        if pool.device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return pool, master, walls


def free_pod(master) -> None:
    """Delete every published snapshot and reclaim its storage."""
    for e in list(master.catalog.entries):
        if e.regions is not None:
            master.delete(e.name)
    master.gc()


def _write(out: dict, name: str) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / name).write_text(json.dumps(out, indent=2))


def bench_config(quick: bool) -> dict:
    """The single-pod bench's configuration (the reference's, number for
    number): the fleet, the pod's pages per variant, the traffic, the hosts
    and the hot bytes the profiles are extrapolated to."""
    if quick:
        return dict(n_types=24, n_bases=6, hot=48, cold=24, zero=16, delta=4,
                    total_rps=500.0, t_end=8.0, compute_mean=0.25,
                    n_hosts=6, slots=16, max_hosts=32, n_sample=4, target_hot=64 << 20)
    return dict(n_types=200, n_bases=16, hot=64, cold=32, zero=16, delta=6,
                total_rps=4000.0, t_end=45.0, compute_mean=2.0,
                n_hosts=48, slots=64, max_hosts=192, n_sample=8, target_hot=256 << 20)


def run(quick: bool = False, device="cuda", walls: dict | None = None) -> dict:
    """The single-pod bench; ``walls`` (if given) receives each step's wall
    seconds.  The pod is freed before returning."""
    timed = functools.partial(_timed, {} if walls is None else walls)
    c = bench_config(quick)
    n_types, n_bases = c["n_types"], c["n_bases"]
    hot, cold, zero, delta = c["hot"], c["cold"], c["zero"], c["delta"]
    total_rps, t_end, compute_mean = c["total_rps"], c["t_end"], c["compute_mean"]
    n_hosts, slots, max_hosts = c["n_hosts"], c["slots"], c["max_hosts"]
    n_sample, target_hot = c["n_sample"], c["target_hot"]

    fleet = synthesize_fleet(n_types, n_bases, total_rps, seed=SEED,
                             compute_mean_s=compute_mean)
    pool, master, images, probes = timed("build_pod", build_pod, fleet, hot, cold, zero,
                                         delta, device=device)
    profiles, model_err = timed("profile_pod", profile_pod, pool, master, fleet)
    bit_identical, n_verified = timed("verify_restores", verify_restores, pool, master,
                                      images, fleet, n_sample)
    capacity = master.capacity.report()
    free_pod(master)
    del pool, master, images
    # extrapolate the (exactness-checked) profiles to production-size
    # images — same layout shape, target_hot hot bytes
    scale = target_hot / (hot * PAGE_SIZE)
    profiles = {k: p.scaled(scale) for k, p in profiles.items()}
    trace = generate_trace(fleet, t_end, seed=SEED)

    results = {p: timed(f"drive_{p}", drive, fleet, profiles, trace, p, n_hosts, slots,
                        max_hosts)
               for p in POLICIES}
    policies = {p: r.summary() for p, r in results.items()}
    # bit-determinism: an identically-seeded locality re-run must match
    r2 = timed("drive_locality_rerun", drive, fleet, profiles, trace, "locality", n_hosts,
               slots, max_hosts)
    deterministic = same_result(results["locality"], r2)

    loc, rnd = policies["locality"], policies["random"]
    p99_x = (rnd["p99_cold_start_s"] / loc["p99_cold_start_s"]
             if loc["p99_cold_start_s"] > 0 else float("inf"))
    shared_frac = float_mean(np.array(
        [profiles[f.fn_id].shared_base_bytes
         / max(1, profiles[f.fn_id].hot_bytes) for f in fleet]))
    criteria = {
        "locality_vs_random_p99_ge_1_3x": bool(p99_x >= 1.3),
        "bit_deterministic": deterministic,
        "restores_bit_identical": bit_identical,
        "profile_matches_restore_model": bool(model_err == 0.0),
        "all_completed": bool(all(p["completed"] == p["invocations"]
                                  for p in policies.values())),
    }
    if not quick:
        criteria["ge_200_function_types"] = bool(n_types >= 200)
        criteria["ge_10k_peak_inflight"] = bool(
            loc["inflight_peak"] >= 10_000)
    out = {
        "quick": quick, "seed": SEED,
        "fleet": {"n_types": n_types, "n_bases": n_bases,
                  "hot_pages": hot, "cold_pages": cold, "zero_pages": zero,
                  "delta_pages": delta, "total_rps": total_rps,
                  "t_end_s": t_end, "invocations": len(trace),
                  "n_hosts": n_hosts, "slots_per_host": slots,
                  "max_hosts": max_hosts},
        "pod": {"profile_scale_x": scale,
                "probe_marginal_bytes_total": int(sum(probes)),
                "probe_marginal_bytes_first": int(probes[0]),
                "probe_marginal_bytes_last": int(probes[-1]),
                "mean_shared_base_frac": shared_frac,
                "restores_verified": n_verified,
                "capacity": capacity},
        "policies": policies,
        "locality_vs_random_p99_x": p99_x,
        "criteria": criteria,
    }
    _write(out, "fleet_bench_quick.json" if quick else "fleet_bench.json")
    return out


def drive_topo(fleet, profiles, trace, topo, n_hosts, slots):
    """One locality-policy run with a FleetTopology surcharging the
    scheduler's scores and the driver's restore charges; no autoscaler."""
    d = FleetDriver(fleet, profiles, policy="locality", seed=SEED,
                    n_hosts=n_hosts, slots_per_host=slots,
                    clock=VirtualClock())
    d.scheduler.topology = topo
    return d.run(trace)


def run_multipod(quick: bool = False, device="cuda", walls: dict | None = None) -> dict:
    """Multi-pod tier: replication + migration economics against the
    single-big-pod and no-replication baselines at equal TOTAL CXL budget
    (the reference's ``run_multipod``, step for step)."""
    timed = functools.partial(_timed, {} if walls is None else walls)
    if quick:
        n_types, n_bases = 24, 6
        hot, cold, zero, delta = 48, 24, 16, 4
        total_rps, t_end, compute_mean = 500.0, 8.0, 0.25
        n_hosts, slots = 6, 64
        n_pods, device_ports = 3, 2
        target_hot = 64 << 20
    else:
        n_types, n_bases = 200, 16
        hot, cold, zero, delta = 64, 32, 16, 6
        total_rps, t_end, compute_mean = 2000.0, 45.0, 1.0
        n_hosts, slots = 48, 96
        n_pods, device_ports = 4, 12
        target_hot = 256 << 20

    fleet = synthesize_fleet(n_types, n_bases, total_rps, seed=SEED,
                             compute_mean_s=compute_mean)
    pool, master, images, _probes = timed("build_pod", build_pod, fleet, hot, cold, zero,
                                          delta, device=device)
    profiles, model_err = timed("profile_pod", profile_pod, pool, master, fleet)
    bit_identical, n_verified = timed("verify_restores", verify_restores, pool, master,
                                      images, fleet, 4)
    free_pod(master)
    del pool, master, images
    scale = target_hot / (hot * PAGE_SIZE)
    profiles = {k: p.scaled(scale) for k, p in profiles.items()}
    trace = generate_trace(fleet, t_end, seed=SEED)

    # equal TOTAL CXL budget across tiers: 1.5x the fleet's hot bytes
    budget = int(1.5 * sum(p.hot_bytes for p in profiles.values()))

    plans = {"single_pod": (1, plan_single(fleet)),
             "no_replication": (n_pods, plan_balanced(fleet, profiles,
                                                      n_pods)[0])}
    tiers, topos = {}, {}

    def run_tier(tier, k, plan):
        topo = FleetTopology(k, device_ports, plan)
        result = timed(f"drive_{tier}", drive_topo, fleet, profiles, trace, topo,
                       n_hosts, slots)
        s = result.summary()
        s["topology"] = dict(topo.stats)
        s["n_pods"] = k
        s["attached_hosts"] = sum(1 for h in range(n_hosts)
                                  if topo.attached(h))
        tiers[tier] = s
        topos[tier] = (topo, result)
        return result

    for tier, (k, plan) in plans.items():
        run_tier(tier, k, plan)

    # measured demand: a second replica serves one pod's share of the cold
    # restores actually paid without it
    base = topos["no_replication"][1]
    cold_mask = base.mode == 0          # MODE_COLD
    cold_by_fn = np.bincount(base.fn[cold_mask].astype(int),
                             minlength=n_types)
    expected_reads = {f.fn_id: float(cold_by_fn[f.fn_id]) / n_pods
                      for f in fleet}
    rep_plan, rep_stats = plan_replicated(fleet, profiles, n_pods, budget,
                                          expected_reads)
    run_tier("replicated", n_pods, rep_plan)

    # bit-determinism: an identically-seeded replicated re-run must match
    r2 = timed("drive_replicated_rerun", drive_topo, fleet, profiles, trace,
               FleetTopology(n_pods, device_ports, rep_plan), n_hosts, slots)
    deterministic = same_result(topos["replicated"][1], r2)

    rep, single, norep = (tiers["replicated"], tiers["single_pod"],
                          tiers["no_replication"])
    criteria = {
        "replicated_beats_single_pod_p99": bool(
            rep["p99_cold_start_s"] < single["p99_cold_start_s"]),
        "replicated_beats_no_replication_p99": bool(
            rep["p99_cold_start_s"] <= norep["p99_cold_start_s"]),
        "economics_gate_filtered": bool(
            rep_stats["replicas_added"] > 0
            and rep_stats["skipped_uneconomic"] > 0),
        "bit_deterministic": deterministic,
        "restores_bit_identical": bit_identical,
        "profile_matches_restore_model": bool(model_err == 0.0),
        "all_completed": bool(all(t["completed"] == t["invocations"]
                                  for t in tiers.values())),
    }
    out = {
        "quick": quick, "seed": SEED,
        "fleet": {"n_types": n_types, "n_bases": n_bases,
                  "invocations": len(trace), "t_end_s": t_end,
                  "n_hosts": n_hosts, "slots_per_host": slots,
                  "n_pods": n_pods, "device_ports": device_ports,
                  "total_cxl_budget_bytes": budget,
                  "restores_verified": n_verified},
        "replication_plan": rep_stats,
        "tiers": tiers,
        "single_vs_replicated_p99_x": (
            single["p99_cold_start_s"] / rep["p99_cold_start_s"]
            if rep["p99_cold_start_s"] > 0 else float("inf")),
        "criteria": criteria,
    }
    _write(out, "fleet_bench_multipod_quick.json" if quick else "fleet_bench_multipod.json")
    return out


def main_multipod(quick: bool, device) -> int:
    out = run_multipod(quick=quick, device=device)
    f = out["fleet"]
    print(f"multipod: {f['n_types']} types, {f['invocations']} invocations, "
          f"{f['n_pods']} pods x {f['device_ports']} ports, "
          f"budget {f['total_cxl_budget_bytes'] >> 20} MiB total")
    print(f"replication plan: {out['replication_plan']}")
    for tier, s in out["tiers"].items():
        topo = s["topology"]
        print(f"{tier:>16}: p50 {s['p50_cold_start_s']*1e3:8.3f} ms  "
              f"p99 {s['p99_cold_start_s']*1e3:8.3f} ms  "
              f"local/remote/unattached {topo['local_placements']}/"
              f"{topo['remote_placements']}/{topo['unattached_placements']}")
    print(f"single_pod vs replicated p99: "
          f"{out['single_vs_replicated_p99_x']:.2f}x")
    ok = all(out["criteria"].values())
    print(f"criteria: {out['criteria']}  ->  {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="small fleet")
    ap.add_argument("--multipod", action="store_true",
                    help="multi-pod replication/migration tier")
    ap.add_argument("--device", default="cuda", help="the pool's device (default cuda)")
    args = ap.parse_args()
    if args.multipod:
        return main_multipod(args.quick, args.device)
    out = run(quick=args.quick, device=args.device)
    f = out["fleet"]
    print(f"fleet: {f['n_types']} types / {f['n_bases']} bases, "
          f"{f['invocations']} invocations over {f['t_end_s']}s "
          f"({f['total_rps']:.0f} rps offered)")
    print(f"pod: shared-base frac {out['pod']['mean_shared_base_frac']:.3f}, "
          f"probe marginal first/last "
          f"{out['pod']['probe_marginal_bytes_first'] >> 10}/"
          f"{out['pod']['probe_marginal_bytes_last'] >> 10} KiB, "
          f"{out['pod']['restores_verified']} real restores verified")
    for name, p in out["policies"].items():
        print(f"{name:>12}: p50 {p['p50_cold_start_s']*1e3:8.3f} ms  "
              f"p99 {p['p99_cold_start_s']*1e3:8.3f} ms  "
              f"warm {p['warm_frac']:.3f}  join {p['join_frac']:.3f}  "
              f"hosts {p['host_peak']}  inflight {p['inflight_peak']}")
    print(f"locality vs random p99: {out['locality_vs_random_p99_x']:.2f}x")
    ok = all(out["criteria"].values())
    print(f"criteria: {out['criteria']}  ->  {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
