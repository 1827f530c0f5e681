#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s topology and sim phases on one NVIDIA card.

    python3 scripts/topology_phase.py [--seed 0] [--phase both|topology|sim] [--out build/topology]

Builds the kernels; for the topology phase makes the smoke's 1.5 GiB image
from ``--seed`` (same pages, same working set) and runs
``chip_smoke.topology_phase`` (cell (6): three pods, a replicated publish, an
update racing 9 routed borrowers and a full restore, a migration, a
partition and its heal, a pod loss, a group delete; I1–I8 after every step);
the sim phase runs ``chip_smoke.sim_phase`` (every scenario of
``scripts/sim_scenarios.py`` on the card against the CPU).  Prints the
phases' lines; the report goes to ``--out``/topology.json.  Exits non-zero
without a CUDA card.
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
    ap.add_argument("--phase", choices=("both", "topology", "sim"), default="both")
    ap.add_argument("--out", default=str(ROOT / "build" / "topology"))
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("topology_phase: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.core import ArrayExtent, Manifest, StateImage
    from repro_torch.kernels import build

    build.build()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    rep = {"card": card}
    t0 = time.perf_counter()
    if args.phase in ("both", "topology"):
        n = cs.PAPER_INSTANCE_PAGES
        buf, hot = cs.make_image(n, args.seed, torch.device("cuda", 0))
        image = StateImage(Manifest([ArrayExtent("guest", 0, n * cs.PAGE, (n * cs.PAGE,),
                                                 "uint8")], n), buf)
        hot_np = hot.cpu().numpy()
        zero_np = ~image.pages_matrix().any(dim=1).cpu().numpy()
        cs.log("topology:")
        rep["topology"] = cs.topology_phase(torch, np, image, np.flatnonzero(hot_np),
                                            np.flatnonzero(~hot_np & ~zero_np), args.seed)
        cs.log_topology(rep["topology"], card)
        del image, buf
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    if args.phase in ("both", "sim"):
        cs.log("sim:")
        rep["sim"] = cs.sim_phase(torch)
        cs.log_sim(rep["sim"], card)
    t2 = time.perf_counter()
    cs.log(f"topology phase {t1 - t0:.2f} s, sim phase {t2 - t1:.2f} s, together "
           f"{t2 - t0:.2f} s on {card}")
    (out / "topology.json").write_text(json.dumps(rep, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
