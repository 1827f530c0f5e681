#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s moe phase on one NVIDIA card.

    python3 scripts/moe_phase.py [--seed 0] [--out build/moe]

Builds the kernels and runs ``chip_smoke.moe_phase``: the flash forward at
the MoE family's two full-width shapes and the Dk != Dv backward against
their plain versions; OLMoE-1B-7B at full width and depth (forward and
serving); DeepSeek-V3 at full width on two layers with its MTP head
(``lm_forward_mtp``, serving with MLA's absorbed and re-expanded decodes);
float32 decode against forward for both; the recognition workload's image
published and restored.  Prints the phase's lines; the report goes to
``--out``/moe.json.  Exits non-zero without a CUDA card.
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
    ap.add_argument("--out", default=str(ROOT / "build" / "moe"))
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("moe_phase: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    cs.log(f"build {time.perf_counter() - t0:.2f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "flash_attention_bwd" in name and ("registers" in line or "spill" in line):
                cs.log(f"  {name}: {line.strip()}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    t0 = time.perf_counter()
    cs.log("moe:")
    rep = cs.moe_phase(torch, np, args.seed, torch.device("cuda", 0), out)
    cs.log(f"moe phase {time.perf_counter() - t0:.2f} s on {card}")
    (out / "moe.json").write_text(json.dumps({"card": card, "moe": rep}, indent=1,
                                             default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
