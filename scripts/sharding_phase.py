#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s sharding phase on one NVIDIA card.

    python3 scripts/sharding_phase.py [--seed 0] [--out build/sharding]

Builds the kernels and runs ``chip_smoke.sharding_phase``: (a)
``compressed_psum`` over xLSTM-125M's gradients on a one-rank NCCL group;
(b) the elastic-restore twin at full width; (c) one dry-run cell in a
subprocess.  Prints the phase's lines; the report goes to
``--out``/sharding.json.  Exits non-zero without a CUDA card.
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
    ap.add_argument("--out", default=str(ROOT / "build" / "sharding"))
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("sharding_phase: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    cs.log(f"build {time.perf_counter() - t0:.2f} s")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    t0 = time.perf_counter()
    cs.log("sharding:")
    rep = cs.sharding_phase(torch, np, args.seed, torch.device("cuda", 0), out)
    cs.log(f"sharding phase {time.perf_counter() - t0:.2f} s on {card}")
    (out / "sharding.json").write_text(json.dumps({"card": card, "sharding": rep}, indent=1,
                                                  default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
