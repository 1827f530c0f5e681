#!/usr/bin/env python3
"""Benchmark driver of the PyTorch port: one twin per paper table or figure.

    PYTHONPATH=src python scripts/run.py [--device cuda|cpu]

The port's twin of ``benchmarks/run.py``.  Order: characterization (Fig. 3)
→ run lengths (Fig. 4) → breakdown (Fig. 6) → scalability (Fig. 7) →
kernel bench, each through its own ``main`` on ``--device``.  Their JSON
files land in ``experiments/torch/`` with ``--device cpu`` (the committed
CPU runs), in ``build/benches/`` otherwise, and a combined
``bench_summary.json`` beside them, which carries the wall clock and is not
committed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    import breakdown
    import characterization
    import kernel_bench
    import runlength
    import scalability

    dev = ["--device", args.device]
    summary = {"device": args.device}
    rcs = {}
    t0 = time.perf_counter()

    def section(title: str) -> None:
        print(("\n" if rcs else "") + "=" * 72)
        print(title)
        print("=" * 72)

    section("Fig 3 analogue — snapshot image composition")
    rcs["characterization"] = characterization.main(dev)
    out = characterization.OUT         # each twin's main set it from the device
    summary["characterization"] = json.loads(
        (out / "characterization.json").read_text())["average"]

    section("Fig 4 analogue — hot-set run-length distribution")
    rcs["runlength"] = runlength.main(dev)
    summary["runlength"] = json.loads((out / "runlength.json").read_text())["aggregate"]

    section("Fig 6 analogue — invocation breakdown (chameleon @32)")
    rcs["breakdown"] = breakdown.main(dev)
    b = json.loads((out / "breakdown.json").read_text())
    summary["breakdown"] = {
        "speedup_vs_firecracker": b["speedup_vs_firecracker"],
        "speedup_vs_faasnap": b["speedup_vs_faasnap"],
        "restore_bit_identical": b["restore_bit_identical"],
    }

    section("Fig 7 analogue — scalability 1..32 + headline geomeans")
    rcs["scalability"] = scalability.main(dev)
    summary["scalability"] = json.loads(
        (out / "scalability.json").read_text())["geomean_speedups_at_32"]

    section("kernel bench — snapshot-pipeline kernels")
    rcs["kernel_bench"] = kernel_bench.main(dev)

    summary["exit_codes"] = rcs
    summary["wall_s"] = time.perf_counter() - t0
    (out / "bench_summary.json").write_text(json.dumps(summary, indent=2))
    print(f"\nall benchmarks done in {summary['wall_s']:.1f}s -> {out}")
    return 0 if not any(rcs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
