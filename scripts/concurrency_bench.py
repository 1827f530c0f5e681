#!/usr/bin/env python3
"""Co-located restore concurrency benchmark on the PyTorch port: the shared
``NodePageServer`` against per-instance engines.

    PYTHONPATH=src python scripts/concurrency_bench.py [--quick] [--device cuda|cpu]

The port's twin of ``benchmarks/concurrency_bench.py``, with the same
images, sweep and steps, every pool on ``device`` and every publish through
the fused sweep (``kernels.make_fused_publish_fn()``).  For each point,
``conc`` co-located restores on one host are attached before any page
moves, then each is driven on its own thread to completion (hot
pre-install, zero runs, background cold-extent prefetch):

  shared   : one host-wide AsyncRDMAEngine, completion worker and DRR
             prefetch pump for all restores, with hot-chunk and cold-extent
             fan-out across same-snapshot restores;
  perinst  : a private engine, completion thread and prefetcher per restore.

Scenarios ``same`` (all restores of one snapshot) and ``mixed`` (one
snapshot each).  Per point: per-instance modeled restore time (p50/p99),
aggregate modeled throughput, bit-identity of every restore
(``torch.equal``), the worst relative error of the executed modeled time
against ``strategies.modeled_concurrent_restore_s``, and ``wall_s``, the
point's wall clock (the only key that is not modeled).  Acceptance: at
conc >= 8 same-snapshot the shared runtime gives >= 1.5x the baseline's
throughput, every restore bit-identical, the model within 15%.  Results go
to ``experiments/torch/concurrency_bench{,_quick}.json`` (the committed CPU
runs; ``build/benches/`` with another ``--device``).
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (HierarchicalPool, LayoutOrderPolicy, Orchestrator,  # noqa: E402
                              PoolMaster, StateImage)
from repro_torch.core.pagestore import PAGE_SIZE  # noqa: E402
from repro_torch.core.profiler import AccessRecorder  # noqa: E402
from repro_torch.kernels import make_fused_publish_fn  # noqa: E402
from repro_torch.serve.strategies import modeled_concurrent_restore_s  # noqa: E402

OUT = ROOT / "experiments" / "torch"

FULL_CONCS_SAME = (1, 2, 4, 8, 16, 32)
FULL_CONCS_MIXED = (1, 2, 4, 8)
QUICK_CONCS_SAME = (1, 8)


def make_restore_image(seed: int = 0, hot_pages: int = 512,
                       cold_pages: int = 1536, zero_pages: int = 2048, device="cuda"):
    """Snapshot-shaped image: contiguous hot params + a cold runtime mass
    with a few short hot spans (Fig-4 fragmentation) + a zero arena."""
    rng = np.random.default_rng(seed)
    arrays = {
        "params": rng.standard_normal(hot_pages * PAGE_SIZE // 4).astype(np.float32),
        "runtime": rng.integers(1, 7, (cold_pages * PAGE_SIZE,)).astype(np.uint8),
        "arena": np.zeros(zero_pages * PAGE_SIZE, np.uint8),
    }
    img = StateImage.build(arrays, device=device)
    rec = AccessRecorder(img.manifest)
    rec.touch_array("params")
    rt = img.manifest.by_name()["runtime"]
    for s in range(7, cold_pages - 4, max(8, cold_pages // 24)):
        rec.touch_pages(range(rt.first_page + s, rt.first_page + s + 2))
    return img, rec.working_set()


def run_point(conc: int, shared: bool, same_snapshot: bool, images,
              max_extent_pages: int = 64) -> dict:
    pool = HierarchicalPool(cxl_capacity=512 << 20, rdma_capacity=1 << 30,
                            device=images[0][0].device)
    master = PoolMaster(pool, publish_fn=make_fused_publish_fn())
    n_snaps = 1 if same_snapshot else conc
    for i in range(n_snaps):
        img, ws = images[i]
        master.publish(f"snap{i}", img, ws)
    policy = LayoutOrderPolicy(max_extent_pages)
    orch = Orchestrator("host0", pool, master.catalog, use_async_rdma=True,
                        use_node_server=shared, prefetch_policy=policy)
    # attach every restore BEFORE any page movement so all `conc` streams
    # contend for the whole restore window (the load balancer dispatching a
    # co-located burst), then drive them concurrently to completion
    ris = []
    for k in range(conc):
        ri = orch.restore(f"snap{0 if same_snapshot else k}",
                          pre_install=False, prefetch_cold=False)
        assert ri is not None
        ris.append(ri)
    errs = []

    def drive(ri):
        try:
            ri.engine.pre_install_hot()
            ri.engine.install_zero_runs()
            ri.engine.start_prefetcher(policy=policy)
            if not ri.engine.wait_prefetch_idle(120.0):
                raise TimeoutError("prefetch did not complete")
        except Exception as exc:            # pragma: no cover
            errs.append(exc)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=drive, args=(ri,)) for ri in ris]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    assert not errs, errs

    groups = 1 if (shared and same_snapshot) else conc
    times, model_errs, identical = [], [], True
    for k, ri in enumerate(ris):
        src = images[0 if same_snapshot else k][0]
        ok = bool(ri.instance.present.all()) and \
            bool(torch.equal(ri.instance.image.buf, src.buf))
        identical = identical and ok
        t_exec = ri.ledger.total()
        t_model = modeled_concurrent_restore_s(ri.engine.reader, groups,
                                               max_extent_pages)
        times.append(t_exec)
        model_errs.append(abs(t_exec - t_model) / t_model)
    bytes_total = sum(images[0 if same_snapshot else k][0].buf.nbytes
                      for k in range(conc))
    makespan = max(times)
    for ri in ris:
        ri.shutdown()
    orch.close()
    times_a = np.asarray(times)
    return {
        "conc": conc,
        "mode": "shared" if shared else "perinst",
        "scenario": "same" if same_snapshot else "mixed",
        "restore_p50_ms": float(np.percentile(times_a, 50) * 1e3),
        "restore_p99_ms": float(np.percentile(times_a, 99) * 1e3),
        "restore_max_ms": float(makespan * 1e3),
        "agg_throughput_GBps": bytes_total / makespan / 1e9,
        "model_err_max": float(max(model_errs)),
        "bit_identical": identical,
        "wall_s": wall_s,
    }


def run(quick: bool = False, device="cuda") -> dict:
    kw = dict(hot_pages=256, cold_pages=512, zero_pages=768) if quick else {}
    concs_same = QUICK_CONCS_SAME if quick else FULL_CONCS_SAME
    concs_mixed = () if quick else FULL_CONCS_MIXED
    n_images = max((1,) + tuple(concs_mixed))
    images = [make_restore_image(seed=i, device=device, **kw) for i in range(n_images)]

    rows = []
    for conc in concs_same:
        for shared in (False, True):
            rows.append(run_point(conc, shared, same_snapshot=True, images=images))
    for conc in concs_mixed:
        for shared in (False, True):
            rows.append(run_point(conc, shared, same_snapshot=False, images=images))

    def tput(conc, mode, scen):
        return next(r["agg_throughput_GBps"] for r in rows
                    if r["conc"] == conc and r["mode"] == mode
                    and r["scenario"] == scen)

    gains = {c: tput(c, "shared", "same") / tput(c, "perinst", "same")
             for c in concs_same}
    model_err_max = max(r["model_err_max"] for r in rows)
    criteria = {
        "gain_same_snapshot_by_conc": {str(c): g for c, g in gains.items()},
        "gain_at_conc_ge_8": min((g for c, g in gains.items() if c >= 8),
                                 default=None),
        "gain_ok": all(g >= 1.5 for c, g in gains.items() if c >= 8),
        "model_err_max": model_err_max,
        "model_within_15pct": model_err_max <= 0.15,
        "all_bit_identical": all(r["bit_identical"] for r in rows),
    }
    out = {"rows": rows, "criteria": criteria, "quick": quick}
    OUT.mkdir(parents=True, exist_ok=True)
    name = "concurrency_bench_quick.json" if quick else "concurrency_bench.json"
    (OUT / name).write_text(json.dumps(out, indent=2))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="2-point same-snapshot sweep")
    ap.add_argument("--device", default="cuda", help="the pools' device (default cuda)")
    args = ap.parse_args()
    if args.device != "cpu":        # experiments/torch/ holds the CPU runs
        global OUT
        OUT = ROOT / "build" / "benches"
    out = run(quick=args.quick, device=args.device)
    hdr = (f"{'conc':>5s} {'scenario':>9s} {'mode':>8s} {'p50(ms)':>9s} "
           f"{'p99(ms)':>9s} {'agg GB/s':>9s} {'model err':>10s}  ok")
    print(hdr)
    for r in out["rows"]:
        print(f"{r['conc']:5d} {r['scenario']:>9s} {r['mode']:>8s} "
              f"{r['restore_p50_ms']:9.2f} {r['restore_p99_ms']:9.2f} "
              f"{r['agg_throughput_GBps']:9.2f} {r['model_err_max']:10.3f}  "
              f"{r['bit_identical']}")
    c = out["criteria"]
    print(f"\nshared-vs-perinst same-snapshot gain: "
          + ", ".join(f"{k}x{v:.2f}" for k, v in
                      c["gain_same_snapshot_by_conc"].items()))
    print(f"gain at conc>=8 >= 1.5x: {c['gain_ok']}   "
          f"model within 15%: {c['model_within_15pct']} "
          f"(max err {c['model_err_max']:.3f})   "
          f"all bit-identical: {c['all_bit_identical']}")
    return 0 if (c["gain_ok"] and c["model_within_15pct"] and c["all_bit_identical"]) else 1


if __name__ == "__main__":
    sys.exit(main())
