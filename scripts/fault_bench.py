#!/usr/bin/env python3
"""Fault-tolerance benchmark on the PyTorch port.

    PYTHONPATH=src python scripts/fault_bench.py [--quick] [--device cuda|cpu]

The port's twin of ``benchmarks/fault_bench.py``, with the same seeds, the
same numpy bytes and the same steps.  Four sweeps restore the same
fused-published snapshot through the serving path
(``RestoreEngine.install_all_sync`` with a checksum-verifying
``FusedScatter``), each under a deterministic fault schedule on the real
tiers, all on ``device`` under a ``VirtualClock``:

* ``none`` — the fault-free baseline, run twice: with no injector and with
  an armed but empty ``FaultInjector``; the per-restore ledgers must be
  equal as wholes (the fault seam costs exactly 0 modeled seconds);
* ``rdma_timeouts`` — two RNIC read timeouts per restore, re-issued by the
  seeded retry machinery;
* ``cxl_poison`` — one poisoned hot page per restore, detected by the
  install's checksum and repaired from its home tier;
* ``brownout`` — a CXL host-link brownout over the whole run: every
  restore completes degraded over RDMA, at the modeled all-cold cost.

Every publish runs the fused sweep and every install the fused restore
(one launch each on a CUDA pool; an armed injector makes each walk run
extent by extent).  Modeled seconds are the paper's cost model.  Results
go to ``experiments/torch/fault_bench{,_quick}.json`` (the committed CPU
runs; ``build/benches/`` with another ``--device``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (  # noqa: E402
    FaultInjector,
    HierarchicalPool,
    Instance,
    PoolMaster,
    RestoreEngine,
    SnapshotReader,
    StateImage,
    TimeLedger,
)
from repro_torch.core.pagestore import PAGE_SIZE  # noqa: E402
from repro_torch.fleet.driver import float_sum  # noqa: E402
from repro_torch.kernels import FusedScatter, make_fused_publish_fn  # noqa: E402
from repro_torch.serve.strategies import (  # noqa: E402
    modeled_concurrent_restore_s,
    modeled_degraded_restore_s,
)
from repro_torch.sim import VirtualClock  # noqa: E402

OUT = ROOT / "experiments" / "torch"
SEED = int(os.environ.get("AQUIFER_SIM_SEED", "0"))

SWEEPS = ("none", "rdma_timeouts", "cxl_poison", "brownout")


def make_image(hot_pages: int, cold_pages: int, zero_pages: int,
               seed: int = SEED, device="cuda"):
    rng = np.random.default_rng(seed + 7)
    img = StateImage.build({
        "w": rng.integers(1, 255, hot_pages * PAGE_SIZE).astype(np.uint8),
        "cold": rng.integers(1, 255, cold_pages * PAGE_SIZE).astype(np.uint8),
        "z": np.zeros(zero_pages * PAGE_SIZE, np.uint8),
    }, device=device)
    return img, list(range(hot_pages))


def make_stack(img, ws, cxl_capacity: int = 1 << 30, rdma_capacity: int = 1 << 30):
    """Fresh pool on the image's device + fused publish (so restores carry a
    checksum table); returns ``(pool, master, borrow)``."""
    pool = HierarchicalPool(cxl_capacity=cxl_capacity, rdma_capacity=rdma_capacity,
                            device=img.device)
    master = PoolMaster(pool)
    master.publish("snap", img, ws, publish_fn=make_fused_publish_fn())
    borrow = master.catalog.borrow("snap")
    assert borrow is not None
    return pool, master, borrow


def free_stack(pool, master, borrow) -> None:
    """Release the borrow, delete the snapshot and reclaim it; every pool
    byte must be back."""
    borrow.release()
    master.delete("snap")
    master.gc()
    if pool.cxl.bytes_in_use or pool.rdma.bytes_in_use:
        raise AssertionError(f"pool not back to zero: cxl {pool.cxl.bytes_in_use} "
                             f"rdma {pool.rdma.bytes_in_use}")


def injector_for(sweep: str, r: int, pool, borrow, clock) -> FaultInjector:
    """The per-restore fault schedule.  A fresh injector per restore keeps
    the counts exact (2 timeouts / 1 poison each) whatever a previous
    restore's repairs consumed."""
    inj = FaultInjector(clock=clock, seed=SEED + r)
    if sweep == "rdma_timeouts":
        inj.fail_reads("rdma", 2)
    elif sweep == "cxl_poison":
        probe = SnapshotReader(borrow.regions, pool.host_view(f"probe{r}"), pool.rdma)
        _kind, off = probe.lookup(int(probe.hot_page_indices()[0]))
        inj.poison_reads("cxl", 1, lo=off, hi=off + PAGE_SIZE)
    elif sweep == "brownout":
        inj.brownout("cxl", start_s=0.0, duration_s=1e9)
    return inj


def run_sweep(sweep: str, n_restores: int, img, ws, armed: bool = True, **capacity):
    """``n_restores`` sequential serving-path restores under one schedule
    kind; returns per-restore modeled seconds + fault/repair accounting.
    Keys starting with ``_`` are for the caller, not the report: the
    ledgers, each restore's wall and pages verified.  The stack is freed at
    the end (``capacity``: the pool's tier sizes)."""
    clock = VirtualClock()
    pool, master, borrow = make_stack(img, ws, **capacity)
    restore_s, ledgers, walls, verified = [], [], [], []
    ok = True
    totals = {"retries": 0, "repairs": 0, "degraded": 0, "injected": 0}
    for r in range(n_restores):
        if armed:
            pool.attach_fault_injector(injector_for(sweep, r, pool, borrow, clock))
        led = TimeLedger()
        view = pool.host_view(f"h{r}", led)
        reader = SnapshotReader(borrow.regions, view, pool.rdma)
        reader.invalidate_cxl()
        inst = Instance(StateImage.empty_like(img.manifest, device=img.device), ledger=led,
                        clock=clock)
        scatter = FusedScatter()
        eng = RestoreEngine(reader, inst, None, retry_seed=r, scatter_fn=scatter, clock=clock)
        t0 = time.perf_counter()
        eng.install_all_sync(use_batch=True)
        if img.device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        ok = ok and bool(inst.all_present() and torch.equal(inst.image.buf, img.buf))
        verified.append(scatter.stats["pages_verified"])
        restore_s.append(float(led.total()))
        ledgers.append(dict(led.seconds))
        totals["retries"] += len(eng.retry_trace)
        totals["repairs"] += eng.repair_stats["checksum_repairs"]
        totals["degraded"] += int(eng.degraded_cxl)
        if armed:
            fi = pool.fault_injector
            totals["injected"] += (fi.stats["injected_timeouts"]
                                   + fi.stats["injected_poison"]
                                   + fi.stats["brownout_rejections"])
        del eng, inst, reader, view
    pool.attach_fault_injector(None)
    free_stack(pool, master, borrow)
    arr = np.asarray(restore_s)
    total_s = float_sum(arr)
    bytes_per_restore = img.buf.numel()
    return {
        "n_restores": n_restores,
        "p50_modeled_ms": float(np.percentile(arr, 50) * 1e3),
        "p99_modeled_ms": float(np.percentile(arr, 99) * 1e3),
        "total_modeled_s": total_s,
        "goodput_GBps": float(n_restores * bytes_per_restore / max(total_s, 1e-12) / 1e9),
        "total_retries": totals["retries"],
        "total_repairs": totals["repairs"],
        "n_degraded": totals["degraded"],
        "total_injected": totals["injected"],
        "all_bit_identical": ok,
        "_ledgers": ledgers,
        "_wall_s": walls,
        "_pages_verified": verified,
    }


def degraded_model_ms(img, ws, **capacity) -> dict:
    """The analytic healthy vs degraded restore models over this layout."""
    pool, master, borrow = make_stack(img, ws, **capacity)
    reader = SnapshotReader(borrow.regions, pool.host_view("model"), pool.rdma)
    out = {
        "healthy_ms": float(modeled_concurrent_restore_s(reader, 1) * 1e3),
        "degraded_ms": float(modeled_degraded_restore_s(reader, 1) * 1e3),
    }
    del reader
    free_stack(pool, master, borrow)
    return out


def criteria_of(sweeps: dict, bare: dict, model: dict, n_restores: int) -> dict:
    """The reference's criteria over a bare run, the four sweeps and the
    analytic model (ledgers still attached)."""
    return {
        "fault_free_overhead_zero": bool(sweeps["none"]["_ledgers"] == bare["_ledgers"]),
        "all_bit_identical": bool(all(sweeps[s]["all_bit_identical"] for s in SWEEPS)),
        "retries_recovered": bool(sweeps["rdma_timeouts"]["total_retries"] > 0
                                  and sweeps["rdma_timeouts"]["all_bit_identical"]),
        "repairs_happened": bool(sweeps["cxl_poison"]["total_repairs"] == n_restores),
        "brownout_degrades_not_fails": bool(
            sweeps["brownout"]["n_degraded"] == n_restores
            and sweeps["brownout"]["all_bit_identical"]),
        "degraded_costs_more": bool(
            sweeps["brownout"]["p50_modeled_ms"] > sweeps["none"]["p50_modeled_ms"]
            and model["degraded_ms"] > model["healthy_ms"]),
        # the degraded path's executed ledger must track the analytic
        # all-cold model
        "degraded_model_within_15pct": bool(
            abs(sweeps["brownout"]["p50_modeled_ms"] - model["degraded_ms"])
            <= 0.15 * model["degraded_ms"]),
    }


def strip(row: dict) -> dict:
    """A sweep's report without the caller's ``_`` keys."""
    return {k: v for k, v in row.items() if not k.startswith("_")}


def run(quick: bool = False, device="cuda") -> dict:
    if quick:
        n_restores, hot, cold, zero = 8, 64, 64, 32
    else:
        n_restores, hot, cold, zero = 32, 256, 256, 128
    img, ws = make_image(hot, cold, zero, device=device)

    # fault-free overhead: bare stack vs armed-but-empty injector
    bare = run_sweep("none", n_restores, img, ws, armed=False)
    sweeps = {s: run_sweep(s, n_restores, img, ws) for s in SWEEPS}
    fault_free_identical = sweeps["none"]["_ledgers"] == bare["_ledgers"]
    overhead_pct = (
        0.0 if fault_free_identical
        else abs(sweeps["none"]["total_modeled_s"] - bare["total_modeled_s"])
        / max(bare["total_modeled_s"], 1e-12) * 100.0)
    model = degraded_model_ms(img, ws)
    criteria = criteria_of(sweeps, bare, model, n_restores)
    out = {
        "quick": quick, "seed": SEED,
        "workload": {"n_restores": n_restores, "hot_pages": hot,
                     "cold_pages": cold, "zero_pages": zero},
        "fault_free_overhead_pct": overhead_pct,
        "sweeps": {s: strip(r) for s, r in sweeps.items()},
        "degraded_model": model,
        "criteria": criteria,
    }
    OUT.mkdir(parents=True, exist_ok=True)
    name = "fault_bench_quick.json" if quick else "fault_bench.json"
    (OUT / name).write_text(json.dumps(out, indent=2))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="small snapshot, fewer restores")
    ap.add_argument("--device", default="cuda", help="the pools' device (default cuda)")
    args = ap.parse_args()
    if args.device != "cpu":        # experiments/torch/ holds the CPU runs
        global OUT
        OUT = ROOT / "build" / "benches"
    out = run(quick=args.quick, device=args.device)
    w = out["workload"]
    print(f"workload: {w['n_restores']} restores x "
          f"({w['hot_pages']} hot + {w['cold_pages']} cold + "
          f"{w['zero_pages']} zero) pages, seed {out['seed']}")
    print(f"fault-free overhead of the armed seam: {out['fault_free_overhead_pct']:.3f}%")
    for s in SWEEPS:
        r = out["sweeps"][s]
        print(f"  {s:14s} p50 {r['p50_modeled_ms']:8.3f} ms  "
              f"p99 {r['p99_modeled_ms']:8.3f} ms  "
              f"retries {r['total_retries']:3d}  repairs "
              f"{r['total_repairs']:3d}  degraded {r['n_degraded']:3d}  "
              f"{'bit-identical' if r['all_bit_identical'] else 'CORRUPT'}")
    m = out["degraded_model"]
    print(f"analytic restore model: healthy {m['healthy_ms']:.3f} ms vs "
          f"degraded (RDMA-only) {m['degraded_ms']:.3f} ms")
    ok = all(out["criteria"].values())
    print(f"criteria: {out['criteria']}  ->  {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
