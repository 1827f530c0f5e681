#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s pod phase on one NVIDIA card.

    python3 scripts/pod_phase.py [--seed 0] [--out build/pod]

Builds the kernels, makes the smoke's 1.5 GiB image from ``--seed`` (same
pages, same working set), then runs ``chip_smoke.pod_phase``: PoolMaster
publish, 8 + 1 co-located demand-paged restores through Orchestrator, the
update that drains under them, version 1 restored, delete and gc, with
every check of the smoke.  Prints the phase's lines; the report goes to
``--out``/pod.json and the profiled window's table beside it.  Exits
non-zero without a CUDA card.
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
    ap.add_argument("--out", default=str(ROOT / "build" / "pod"))
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("pod_phase: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.core import ArrayExtent, Manifest, StateImage
    from repro_torch.kernels import build

    build.build()
    n = cs.PAPER_INSTANCE_PAGES
    buf, hot = cs.make_image(n, args.seed, torch.device("cuda", 0))
    image = StateImage(Manifest([ArrayExtent("guest", 0, n * cs.PAGE, (n * cs.PAGE,),
                                             "uint8")], n), buf)
    hot_np = hot.cpu().numpy()
    zero_np = ~image.pages_matrix().any(dim=1).cpu().numpy()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    t0 = time.perf_counter()
    rep = cs.pod_phase(torch, np, image, np.flatnonzero(hot_np),
                       np.flatnonzero(~hot_np & ~zero_np), args.seed, out)
    cs.log_pod(rep, card)
    cs.log(f"pod phase: {time.perf_counter() - t0:.2f} s on {card}")
    (out / "pod.json").write_text(json.dumps(dict(rep, card=card), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
