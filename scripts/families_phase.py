#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s families phase on one NVIDIA card.

    python3 scripts/families_phase.py [--seed 0] [--out build/families]

Builds the kernels and runs ``chip_smoke.families_phase``: the flash forward
at the new families' shapes (Qwen2-VL's GQA 64:8 at D = 128, SeamlessM4T's
non-causal D = 64 and Zamba2's D = 80 on the tensor cores) against its plain
version and timed beside the library call (and at Zamba2's shape the SIMT
kernel); the backward at (80, 80) against autograd and timed beside the SIMT
kernel, the plain version and the library, and the (80, 80) kernels'
registers and spills;
Qwen2-VL-72B at full width on 8 layers, Zamba2-2.7B, xLSTM-125M and
SeamlessM4T-medium at full size (forward, serving, profiles, float32 decode
against forward); the image, pyaes, pagerank and ffmpeg workloads' images
published and restored.  Prints the phase's lines; the report goes to
``--out``/families.json.  Exits non-zero without a CUDA card.
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
    ap.add_argument("--out", default=str(ROOT / "build" / "families"))
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("families_phase: torch.cuda.is_available() is False; this needs an NVIDIA card",
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
    cs.log("families:")
    rep = cs.families_phase(torch, np, args.seed, torch.device("cuda", 0), out)
    cs.log(f"families phase {time.perf_counter() - t0:.2f} s on {card}")
    (out / "families.json").write_text(json.dumps({"card": card, "families": rep}, indent=1,
                                                  default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
