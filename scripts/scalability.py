#!/usr/bin/env python3
"""Fig. 7 analogue on the PyTorch port: end-to-end invocation time against
concurrency (1..32) across the nine workloads and five restore strategies,
and the headline geomean speedups.

    PYTHONPATH=src python scripts/scalability.py [--device cuda|cpu]

The port's twin of ``benchmarks/scalability.py``, over ``scripts/workloads.py``
and the port's ``serve/strategies.py``: each modeled run classifies the
image's pages with the zero scan on ``device``; every time is a modeled
second of the paper's cost model, not a time of the card.  Also the
run-batching ablation (``aquifer_perpage``) and the per-instance hot
pre-install, per page against batched.  Results go to
``experiments/torch/scalability.json`` with ``--device cpu``, to
``build/benches/`` otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from repro_torch.serve.strategies import (  # noqa: E402
    STRATEGIES,
    hot_preinstall_time,
    run_strategy,
)
from workloads import all_workloads, get_workload  # noqa: E402

OUT = ROOT / "experiments" / "torch"
CONCURRENCY = (1, 2, 4, 8, 12, 16, 24, 32)


def run(device="cuda") -> dict:
    results = {}
    preinstall = {}
    for name in all_workloads():
        spec = get_workload(name, device=device).spec()
        per = {}
        for strat in STRATEGIES:
            per[strat] = {str(n): run_strategy(strat, spec, concurrency=n).total_s
                          for n in CONCURRENCY}
        # run-batching ablation: Aquifer with strictly page-at-a-time installs
        per["aquifer_perpage"] = {
            str(n): run_strategy("aquifer", spec, concurrency=n, batched=False).total_s
            for n in CONCURRENCY}
        results[name] = per
        pp = hot_preinstall_time(spec, batched=False)
        bt = hot_preinstall_time(spec, batched=True)
        preinstall[name] = {"per_page_s": pp, "batched_s": bt,
                            "speedup": pp / max(bt, 1e-12)}

    # geomean speedups at n=32 (paper's headline setting)
    def geomean(xs):
        return float(np.exp(np.mean(np.log(xs))))

    speedups = {}
    for base in ("firecracker", "faasnap", "reap", "fctiered"):
        ratios = [results[w][base]["32"] / results[w]["aquifer"]["32"]
                  for w in results]
        speedups[f"vs_{base}"] = geomean(ratios)
    ratios_no_ffmpeg = [results[w]["reap"]["32"] / results[w]["aquifer"]["32"]
                        for w in results if w != "ffmpeg"]
    speedups["vs_reap_excl_ffmpeg"] = geomean(ratios_no_ffmpeg)
    fastest = {w: min(results[w], key=lambda s: results[w][s]["32"]) for w in results}

    out = {
        "results": results,
        "geomean_speedups_at_32": speedups,
        "fastest_strategy_per_workload": fastest,
        "hot_preinstall_per_page_vs_batched": preinstall,
        "paper": {"vs_firecracker": 2.2, "vs_faasnap": 1.3, "vs_reap": 1.1,
                  "note": "REAP beats Aquifer on ffmpeg (zero pages in WS)"},
    }
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "scalability.json").write_text(json.dumps(out, indent=2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the images' device")
    args = ap.parse_args(argv)
    if args.device != "cpu":        # experiments/torch/ holds the CPU runs
        global OUT
        OUT = ROOT / "build" / "benches"
    out = run(device=args.device)
    print("end-to-end invocation time @concurrency=32 (modeled s):")
    print(f"{'workload':14s}" + "".join(f"{s:>13s}" for s in STRATEGIES))
    for w, per in out["results"].items():
        print(f"{w:14s}" + "".join(f"{per[s]['32']:13.3f}" for s in STRATEGIES))
    g = out["geomean_speedups_at_32"]
    print(f"\ngeomean speedup of Aquifer @32: vs firecracker {g['vs_firecracker']:.2f}x "
          f"(paper 2.2x) | vs faasnap {g['vs_faasnap']:.2f}x (paper 1.3x) | "
          f"vs reap {g['vs_reap']:.2f}x (paper 1.1x)")
    pre = out["hot_preinstall_per_page_vs_batched"]
    print("hot pre-install per-page vs batched (per-instance, modeled):")
    for w, r in pre.items():
        print(f"  {w:14s} {r['per_page_s']*1e3:8.2f} ms -> {r['batched_s']*1e3:8.2f} ms "
              f"({r['speedup']:.2f}x)")
    print(f"fastest per workload: {out['fastest_strategy_per_workload']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
