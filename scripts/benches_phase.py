#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s benches phase on one NVIDIA card.

    python3 scripts/benches_phase.py [--seed 0] [--out build/benches]

Builds the kernels, makes the smoke's 1.5 GiB image from ``--seed`` (same
pages, same working set) and runs ``chip_smoke.benches_phase``: (a) the ten
bench twins of ``chip_smoke.BENCHES``
(``scripts/{dedup,fault,adaptive,concurrency}_bench.py``,
``scripts/{breakdown,serving_bench,characterization,runlength,scalability,
kernel_bench}.py``) at the reference's full configurations against their
committed files in ``experiments/torch/``; (b) the fault sweeps at the
1.5 GiB image.  Prints
the phase's lines; the report goes to ``--out``/benches.json and the twins' JSON files
to ``--out``/benches.  Exits non-zero without a CUDA card.
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
    ap.add_argument("--out", default=str(ROOT / "build" / "benches"))
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("benches_phase: torch.cuda.is_available() is False; this needs an NVIDIA card",
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
    cs.log("benches:")
    rep = cs.benches_phase(torch, np, image, np.flatnonzero(hot.cpu().numpy()), out)
    cs.log(f"benches phase {time.perf_counter() - t0:.2f} s on {card}")
    (out / "benches.json").write_text(json.dumps({"card": card, "benches": rep}, indent=1,
                                                 default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
