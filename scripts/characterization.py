#!/usr/bin/env python3
"""Fig. 3 analogue on the PyTorch port: snapshot image composition across
the nine workloads.

    PYTHONPATH=src python scripts/characterization.py [--device cuda|cpu]

The port's twin of ``benchmarks/characterization.py``.  Page classes are
measured with the zero scan and the profiled working set over the built
images (``scripts/workloads.py``).  The zero-scan kernel is cross-checked
against the host's bitmap on the first 4,096 pages of each image: on the
card that is ``zero_detect``'s CUDA kernel, on the CPU its plain version.

One divergence from the reference: the zstd cold-tier ratio
(``cold_zstd_ratio``, an even sample of 2,048 cold pages) needs the
``zstandard`` module, which the card's machine lacks.  Without it the row
omits the key and the average counts the row at 1.0, as the reference's
average already does for a row without one.  The committed CPU run
(``experiments/torch/characterization.json``) is written without it, so
that the card's run is held to it key for key.  Results go there with
``--device cpu``, to ``build/benches/`` otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from repro_torch.core.snapshot import _compress_cold, _zstd, classify_pages  # noqa: E402
from repro_torch.kernels import zero_detect  # noqa: E402
from workloads import all_workloads, get_workload  # noqa: E402

OUT = ROOT / "experiments" / "torch"
KERNEL_SAMPLE_PAGES = 4096


def run(verify_kernel: bool = True, device="cuda") -> dict:
    rows = []
    for name in all_workloads():
        bw = get_workload(name, device=device)
        classes = classify_pages(bw.image, bw.profile.working_set)
        s = classes.summary()
        total = s["total"]
        row = {
            "workload": name,
            "arch": bw.wdef.arch,
            "total_pages": total,
            "zero_frac": s["zero"] / total,
            "hot_frac": s["hot"] / total,
            "cold_frac": s["cold"] / total,
            "cold_frac_of_nonzero": s["cold"] / max(1, s["cold"] + s["hot"]),
            "image_mb": bw.image.buf.numel() / (1 << 20),
        }
        pm = bw.image.pages_matrix()
        if verify_kernel:
            sample = pm[:KERNEL_SAMPLE_PAGES]
            kb = zero_detect(sample.view(torch.float32)).bool().cpu().numpy()
            nb = sample.any(dim=1).logical_not().cpu().numpy()
            row["kernel_bitmap_match"] = bool(np.array_equal(kb, nb))
        # beyond-paper: zstd cold-tier ratio (even sample of 2k cold pages)
        step = max(1, classes.cold_pages.size // 2048)
        cold = classes.cold_pages[::step][:2048]
        if cold.size and _zstd is not None:
            blob, _ = _compress_cold(pm[torch.from_numpy(cold).to(pm.device)])
            row["cold_zstd_ratio"] = cold.size * 4096 / max(1, len(blob))
        rows.append(row)

    avg = {
        "zero_frac": float(np.mean([r["zero_frac"] for r in rows])),
        "hot_frac": float(np.mean([r["hot_frac"] for r in rows])),
        "cold_frac_of_nonzero": float(np.mean([r["cold_frac_of_nonzero"] for r in rows])),
        "cold_zstd_ratio": float(np.mean([r.get("cold_zstd_ratio", 1.0) for r in rows])),
    }
    out = {"rows": rows, "average": avg,
           "paper": {"zero_frac": 0.828, "hot_frac": 0.055,
                     "cold_frac_of_nonzero": 0.727,
                     "zero_range": [0.469, 0.907]}}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "characterization.json").write_text(json.dumps(out, indent=2))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the images' device")
    args = ap.parse_args(argv)
    if args.device != "cpu":        # experiments/torch/ holds the CPU runs
        global OUT
        OUT = ROOT / "build" / "benches"
    out = run(device=args.device)
    print(f"{'workload':14s}{'total':>8s}{'zero':>8s}{'hot':>8s}{'cold':>8s}  kernel-ok")
    for r in out["rows"]:
        print(f"{r['workload']:14s}{r['total_pages']:8d}{r['zero_frac']:8.1%}"
              f"{r['hot_frac']:8.1%}{r['cold_frac']:8.1%}  {r.get('kernel_bitmap_match')}")
    a = out["average"]
    print(f"{'AVERAGE':14s}{'':8s}{a['zero_frac']:8.1%}{a['hot_frac']:8.1%}"
          f"   cold/nonzero={a['cold_frac_of_nonzero']:.1%}"
          f"   cold-zstd={a['cold_zstd_ratio']:.2f}x")
    p = out["paper"]
    print(f"{'PAPER':14s}{'':8s}{p['zero_frac']:8.1%}{p['hot_frac']:8.1%}"
          f"   cold/nonzero={p['cold_frac_of_nonzero']:.1%}")
    return 0 if all(r.get("kernel_bitmap_match", True) for r in out["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
