#!/usr/bin/env python3
"""Content-addressed dedup benchmark on the PyTorch port.

    PYTHONPATH=src python scripts/dedup_bench.py [--quick] [--device cuda|cpu]

The port's twin of ``benchmarks/dedup_bench.py``, with the same seeds, the
same numpy byte streams and the same steps: two pods with the same CXL
budget publish the same fleet of near-identical variants (shared base hot
pages, per-variant delta rows and cold arena), one with ``dedup=True``, one
without.  Every pool lives on ``device``; every publish runs the fused sweep
(``kernels.make_fused_publish_fn()``: one launch on a CUDA pool, the plain
version on a CPU one).  Every variant in both pods is restored through the
serving path and compared with its image (``torch.equal``); at the end each
store's refcounts must equal the catalog's live offset pointers (I6).

Reported: the effective-capacity multiplier (variants resident with their
full hot set, dedup over baseline; the bar is 1.5x), the unique-byte ratio,
modeled publish and restore costs and the ``dedup_economics`` verdict.  The
modeled publish costs read the port's calibration
(``experiments/torch/kernel_calibration.json``).  Results go to
``experiments/torch/dedup_bench{,_quick}.json`` (the committed CPU
runs; ``build/benches/`` with another ``--device``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (  # noqa: E402
    HierarchicalPool,
    Instance,
    PoolMaster,
    RestoreEngine,
    SnapshotReader,
    StateImage,
    decode_dedup_offsets,
)
from repro_torch.core.pagestore import PAGE_SIZE  # noqa: E402
from repro_torch.core.pool import TIER_CXL, TIER_RDMA  # noqa: E402
from repro_torch.kernels import make_fused_publish_fn  # noqa: E402
from repro_torch.serve.strategies import (  # noqa: E402
    HOT_CHUNK_PAGES,
    baseline_publish_cost_s,
    dedup_economics,
    dedup_publish_cost_s,
    modeled_concurrent_restore_s,
)

OUT = ROOT / "experiments" / "torch"
SEED = int(os.environ.get("AQUIFER_SIM_SEED", "0"))


def make_fleet(n_variants: int, hot_pages: int, cold_pages: int,
               zero_pages: int, delta_pages: int, seed: int = SEED, device="cuda"):
    """N fine-tuned variants: shared base weights + per-variant delta rows +
    per-variant cold arena, the reference's numpy bytes moved to ``device``."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 255, hot_pages * PAGE_SIZE, dtype=np.int64).astype(np.uint8)
    fleet = []
    for v in range(n_variants):
        w = base.copy()
        lo = (v * delta_pages) % hot_pages
        for d in range(delta_pages):
            p = (lo + d) % hot_pages
            w[p * PAGE_SIZE:(p + 1) * PAGE_SIZE] = \
                rng.integers(1, 255, PAGE_SIZE).astype(np.uint8)
        fleet.append(StateImage.build({
            "w": w,
            "cold": rng.integers(1, 255, cold_pages * PAGE_SIZE).astype(np.uint8),
            "z": np.zeros(zero_pages * PAGE_SIZE, np.uint8),
        }, device=device))
    return fleet


def restore_and_verify(pool, master, name, img):
    """Full serving-path restore (borrow → flush → extent-walk install) and
    compare; returns (bit_identical, executed modeled seconds)."""
    borrow = master.catalog.borrow(name)
    assert borrow is not None, f"borrow of {name} failed"
    try:
        reader = SnapshotReader(borrow.regions, pool.host_view(f"r-{name}"), pool.rdma)
        reader.invalidate_cxl()
        inst = Instance(StateImage.empty_like(img.manifest, device=pool.device))
        eng = RestoreEngine(reader, inst, rdma_engine=None)
        eng.install_all_sync()
        ok = bool(inst.all_present() and torch.equal(inst.image.buf, img.buf))
        return ok, float(inst.ledger.total())
    finally:
        borrow.release()


def run_pod(fleet, budget_bytes, dedup: bool):
    """Publish the whole fleet into one budgeted pod; restore + verify all."""
    pool = HierarchicalPool(cxl_capacity=1 << 30, rdma_capacity=1 << 30,
                            device=fleet[0].device)
    master = PoolMaster(pool, cxl_budget=budget_bytes, dedup=dedup,
                        publish_fn=make_fused_publish_fn())
    publishes = []
    for v, img in enumerate(fleet):
        ws = list(range(img.manifest.by_name()["w"].page_count))
        before_hot = pool.dedup_cxl.unique_pages()
        before_cold = pool.dedup_rdma.unique_pages()
        regions = master.publish(f"v{v}", img, ws)
        publishes.append({
            "n_hot": regions.n_hot, "n_cold": regions.n_cold,
            "new_unique_hot": pool.dedup_cxl.unique_pages() - before_hot,
            "new_unique_cold": pool.dedup_rdma.unique_pages() - before_cold,
        })
    full_hot = fleet[0].manifest.by_name()["w"].page_count
    resident = sum(1 for e in master.catalog.entries
                   if e.regions is not None and e.regions.n_hot == full_hot)
    restores_ok, exec_restore_s = [], 0.0
    sample_reader = None
    for v, img in enumerate(fleet):
        ok, t = restore_and_verify(pool, master, f"v{v}", img)
        restores_ok.append(ok)
        exec_restore_s += t
    # analytic restore model over a resident snapshot's actual layout
    for e in master.catalog.entries:
        if e.regions is not None and e.regions.n_hot == full_hot:
            sample_reader = SnapshotReader(e.regions, pool.host_view("model"), pool.rdma)
            break
    restore_modeled_s = (modeled_concurrent_restore_s(sample_reader, 1)
                         if sample_reader is not None else 0.0)
    report = master.capacity.report()
    return {
        "pool": pool, "master": master, "publishes": publishes,
        "resident_full_hot": resident,
        "demotions": report["demotions"], "degraded": report["degraded"],
        "shared_skips": report["shared_skips"],
        "budget_in_use": report["in_use"],
        "all_bit_identical": bool(all(restores_ok)),
        "exec_restore_total_s": exec_restore_s,
        "restore_modeled_s": restore_modeled_s,
        "sample_reader": sample_reader,
    }


def i6_spot_check(pool, master) -> bool:
    """Store refcounts == live catalog offset pointers, per tier."""
    regions = [e.regions for e in master.catalog.entries
               if e.regions is not None and e.regions.dedup]
    for store, tag in ((pool.dedup_cxl, TIER_CXL), (pool.dedup_rdma, TIER_RDMA)):
        expected = {}
        for r in regions:
            uniq, counts = np.unique(decode_dedup_offsets(pool, r, tag), return_counts=True)
            for off, k in zip(uniq, counts):
                expected[int(off)] = expected.get(int(off), 0) + int(k)
        if expected != store.refcounts():
            return False
    return True


def count_extents(reader):
    n_hot_ext = sum(1 for _ in reader.iter_hot_extents(HOT_CHUNK_PAGES))
    n_cold_ext = sum(1 for _ in reader.iter_cold_extents())
    return n_hot_ext, n_cold_ext


def config(quick: bool):
    """``(n_variants, hot, cold, zero, delta)``: the reference's, number for number."""
    return (8, 64, 32, 16, 4) if quick else (24, 256, 128, 64, 12)


def run(quick: bool = False, device="cuda") -> dict:
    n_variants, hot, cold, zero, delta = config(quick)
    fleet = make_fleet(n_variants, hot, cold, zero, delta, device=device)
    # per-snapshot private CXL need ≈ metadata (2 pages) + full hot set;
    # the budget fits ~1/3 of the fleet without dedup
    per_snapshot = (2 + hot) * PAGE_SIZE
    budget = (n_variants // 3) * per_snapshot

    ded = run_pod(fleet, budget, dedup=True)
    base = run_pod(fleet, budget, dedup=False)

    pool = ded["pool"]
    cxl_rep = pool.dedup_cxl.report()
    rdma_rep = pool.dedup_rdma.report()
    logical = cxl_rep["logical_bytes"] + rdma_rep["logical_bytes"]
    unique = cxl_rep["unique_bytes"] + rdma_rep["unique_bytes"]

    # modeled publish costs over the measured per-tier unique counts
    ded_publish_s = sum(
        dedup_publish_cost_s(p["n_hot"], p["n_cold"],
                             p["new_unique_hot"], p["new_unique_cold"])
        for p in ded["publishes"])
    base_publish_s = sum(baseline_publish_cost_s(p["n_hot"], p["n_cold"])
                         for p in base["publishes"])

    # fragmentation penalty of the dedup layout, from a resident reader
    econ = None
    if ded["sample_reader"] is not None:
        n_hot_ext, n_cold_ext = count_extents(ded["sample_reader"])
        contiguous_hot_ext = -(-hot // HOT_CHUNK_PAGES)
        econ = dedup_economics(
            n_hot=n_variants * hot, n_cold=n_variants * cold,
            n_hot_unique=cxl_rep["unique_pages"],
            n_cold_unique=rdma_rep["unique_pages"],
            n_extra_hot_extents=max(0, n_hot_ext - contiguous_hot_ext),
            n_extra_cold_extents=max(0, n_cold_ext - 1),
            expected_restores=64)

    multiplier = (ded["resident_full_hot"] / base["resident_full_hot"]
                  if base["resident_full_hot"] else float(ded["resident_full_hot"]))
    criteria = {
        "capacity_x_ge_1_5": bool(multiplier >= 1.5),
        "all_restores_bit_identical": bool(ded["all_bit_identical"]
                                           and base["all_bit_identical"]),
        "i6_consistent": i6_spot_check(pool, ded["master"]),
        "dedup_worthwhile": bool(econ is None or econ["worthwhile"]),
    }
    drop = ("pool", "master", "publishes", "sample_reader")
    out = {
        "quick": quick, "seed": SEED,
        "fleet": {"n_variants": n_variants, "hot_pages": hot,
                  "cold_pages": cold, "zero_pages": zero,
                  "delta_pages": delta, "budget_bytes": budget,
                  "per_snapshot_cxl_bytes": per_snapshot},
        "dedup": {**{k: v for k, v in ded.items() if k not in drop},
                  "unique_byte_ratio": unique / logical if logical else 1.0,
                  "unique_bytes": unique, "logical_bytes": logical,
                  "publish_modeled_s": ded_publish_s,
                  "store_cxl": cxl_rep, "store_rdma": rdma_rep,
                  "economics": econ},
        "baseline": {**{k: v for k, v in base.items() if k not in drop},
                     "publish_modeled_s": base_publish_s},
        "effective_capacity_x": multiplier,
        "criteria": criteria,
    }
    OUT.mkdir(parents=True, exist_ok=True)
    name = "dedup_bench_quick.json" if quick else "dedup_bench.json"
    (OUT / name).write_text(json.dumps(out, indent=2))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="small fleet")
    ap.add_argument("--device", default="cuda", help="the pools' device (default cuda)")
    args = ap.parse_args()
    if args.device != "cpu":        # experiments/torch/ holds the CPU runs
        global OUT
        OUT = ROOT / "build" / "benches"
    out = run(quick=args.quick, device=args.device)
    f, d, b = out["fleet"], out["dedup"], out["baseline"]
    print(f"fleet: {f['n_variants']} variants x {f['hot_pages']} hot pages, "
          f"budget {f['budget_bytes'] >> 10} KiB")
    print(f"resident with full hot set: dedup {d['resident_full_hot']} vs "
          f"baseline {b['resident_full_hot']} "
          f"-> {out['effective_capacity_x']:.2f}x effective capacity")
    print(f"unique-byte ratio: {d['unique_byte_ratio']:.3f} "
          f"({d['unique_bytes'] >> 10} KiB physical / {d['logical_bytes'] >> 10} KiB logical)")
    print(f"publish modeled: dedup {d['publish_modeled_s']*1e3:.3f} ms vs "
          f"baseline {b['publish_modeled_s']*1e3:.3f} ms; restore modeled "
          f"{d['restore_modeled_s']*1e3:.3f} ms vs {b['restore_modeled_s']*1e3:.3f} ms")
    if d["economics"]:
        print(f"economics: net {d['economics']['net_s']:.4f} s over "
              f"{int(d['economics']['expected_restores'])} restores "
              f"({'worthwhile' if d['economics']['worthwhile'] else 'NOT worthwhile'})")
    ok = all(out["criteria"].values())
    print(f"criteria: {out['criteria']}  ->  {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
