#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s coldstart phase on one NVIDIA card.

    python3 scripts/coldstart_phase.py [--seed 0] [--out build/coldstart] [--recurate]

Builds the kernels, then runs ``chip_smoke.coldstart_phase``: Phi-4-mini
3.8B at full width from the seed, cut to the smoke's
``chip_smoke.COLDSTART_LAYERS`` layers, published through
``save_checkpoint``, the five modeled strategies, a ``SkeletonPool``
claim, ``restore_server`` with the cold tail prefetched, serving, a profiled second restore, every
array against the regenerated parameters, delete and gc, with every check
of the smoke.  ``--recurate`` first runs the smoke's recurate phase on its
1.5 GiB image (same pages, same working set).  Prints the phase's lines;
the report goes to ``--out``/coldstart.json and the profiled restore's
table beside it.  Exits non-zero without a CUDA card.
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
    ap.add_argument("--out", default=str(ROOT / "build" / "coldstart"))
    ap.add_argument("--recurate", action="store_true",
                    help="run the recurate phase on the smoke's 1.5 GiB image first")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("coldstart_phase: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.core import ArrayExtent, Manifest, StateImage
    from repro_torch.kernels import build

    build.build()
    device = torch.device("cuda", 0)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    rep = {"card": card}
    if args.recurate:
        n = cs.PAPER_INSTANCE_PAGES
        buf, hot = cs.make_image(n, args.seed, device)
        image = StateImage(Manifest([ArrayExtent("guest", 0, n * cs.PAGE, (n * cs.PAGE,),
                                                 "uint8")], n), buf)
        hot_np = hot.cpu().numpy()
        zero_np = ~image.pages_matrix().any(dim=1).cpu().numpy()
        t0 = time.perf_counter()
        rep["recurate"] = cs.recurate_phase(torch, np, image, np.flatnonzero(hot_np),
                                            np.flatnonzero(~hot_np & ~zero_np), args.seed)
        cs.log(f"recurate phase: {time.perf_counter() - t0:.2f} s on {card}")
        del image, buf, hot
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep["coldstart"] = cs.coldstart_phase(torch, np, args.seed, device, out)
    cs.log(f"coldstart phase: {time.perf_counter() - t0:.2f} s on {card}")
    (out / "coldstart.json").write_text(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
