#!/usr/bin/env python3
"""Fig. 4 analogue on the PyTorch port: the distribution of contiguous run
lengths within the hot working set, and the mmap against uffd.copy install
cost of §2.3.4.

    PYTHONPATH=src python scripts/runlength.py [--device cuda|cpu]

The port's twin of ``benchmarks/runlength.py``, over the nine workloads of
``scripts/workloads.py``: the hot pages come from the zero scan on
``device`` and the profiled working set; the install costs are modeled
seconds (the paper's cost model), not times of the card.  Results go to
``experiments/torch/runlength.json`` with ``--device cpu``, to
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

from repro_torch.core.pagestore import runs_from_pages  # noqa: E402
from repro_torch.core.pool import UFFD_COPY_PER_PAGE_S  # noqa: E402
from repro_torch.core.serving import mmap_install_cost  # noqa: E402
from repro_torch.core.snapshot import classify_pages  # noqa: E402
from workloads import all_workloads, get_workload  # noqa: E402

OUT = ROOT / "experiments" / "torch"


def run(device="cuda") -> dict:
    rows = []
    all_lens = []
    for name in all_workloads():
        bw = get_workload(name, device=device)
        classes = classify_pages(bw.image, bw.profile.working_set)
        hot = classes.hot_pages.tolist()
        runs = runs_from_pages(hot)
        lens = np.asarray([n for _, n in runs], dtype=np.float64)
        all_lens.extend(lens.tolist())
        mmap_cost = mmap_install_cost(hot)   # per-page term + per-range syscalls
        uffd_cost = len(hot) * UFFD_COPY_PER_PAGE_S
        rows.append({
            "workload": name,
            "n_hot_pages": len(hot),
            "n_runs": int(lens.size),
            "mean_run": float(lens.mean()) if lens.size else 0.0,
            "frac_runs_lt4": float((lens < 4).mean()) if lens.size else 0.0,
            "mmap_install_s": mmap_cost,
            "uffd_install_s": uffd_cost,
            "mmap_over_uffd": mmap_cost / uffd_cost if uffd_cost else 0.0,
        })
    lens = np.asarray(all_lens)
    cdf_points = {str(k): float((lens <= k).mean()) for k in (1, 2, 3, 4, 8, 16, 64, 256)}
    out = {
        "rows": rows,
        "aggregate": {
            "mean_run": float(lens.mean()),
            "frac_runs_lt4": float((lens < 4).mean()),
            "mean_runs_per_snapshot": float(np.mean([r["n_runs"] for r in rows])),
            "cdf": cdf_points,
        },
        "paper": {"mean_run": 5.0, "frac_runs_lt4": 0.90,
                  "mean_runs_per_snapshot": 4164.2, "mmap_over_uffd": 2.6},
    }
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "runlength.json").write_text(json.dumps(out, indent=2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the images' device")
    args = ap.parse_args(argv)
    if args.device != "cpu":        # experiments/torch/ holds the CPU runs
        global OUT
        OUT = ROOT / "build" / "benches"
    out = run(device=args.device)
    for r in out["rows"]:
        print(f"{r['workload']:14s} hot={r['n_hot_pages']:6d} runs={r['n_runs']:5d} "
              f"mean={r['mean_run']:5.1f} lt4={r['frac_runs_lt4']:4.0%} "
              f"mmap/uffd={r['mmap_over_uffd']:.1f}x (modeled)")
    a = out["aggregate"]
    print(f"AGGREGATE mean_run={a['mean_run']:.1f} lt4={a['frac_runs_lt4']:.0%} "
          f"runs/snapshot={a['mean_runs_per_snapshot']:.0f}  CDF={a['cdf']}")
    print("PAPER     mean_run=5.0 lt4=90% runs/snapshot=4164 (weights are "
          "contiguous in our images → longer runs than a Python heap)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
