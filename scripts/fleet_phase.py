#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s fleet phase on one NVIDIA card.

    python3 scripts/fleet_phase.py [--seed 0] [--out build/fleet] [--full]

Builds the kernels, makes the smoke's 1.5 GiB image from ``--seed`` (same
pages, same working set) and runs ``chip_smoke.fleet_phase``: (a) the fleet
bench twin at the reference's quick configurations (``--full``: its full
ones, as the smoke ran them before it grew) against the committed JSON
files, key for key; (b) the 200-variant pod at 64x the bench's pages,
published, profiled, sampled restores verified, driven and freed; (c) the
``compress_cold`` publish of the image.  Prints the phase's lines; the
report goes to ``--out``/fleet.json and the twin's JSON files to
``--out``/fleet_bench.  Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "fleet"))
    ap.add_argument("--full", action="store_true",
                    help="(a) at the full configurations, held to the full files")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("fleet_phase: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.core import ArrayExtent, Manifest, StateImage
    from repro_torch.kernels import build

    build.build()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    n = cs.PAPER_INSTANCE_PAGES
    buf, hot = cs.make_image(n, args.seed, torch.device("cuda", 0))
    image = StateImage(Manifest([ArrayExtent("guest", 0, n * cs.PAGE, (n * cs.PAGE,),
                                             "uint8")], n), buf)
    t0 = time.perf_counter()
    cs.log("fleet:")
    rep = {"card": card, "fleet": cs.fleet_phase(torch, np, image,
                                                 np.flatnonzero(hot.cpu().numpy()),
                                                 args.seed, out, full=args.full)}
    cs.log(f"fleet phase {time.perf_counter() - t0:.2f} s on {card}")
    (out / "fleet.json").write_text(json.dumps(rep, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
