#!/usr/bin/env python3
"""Write the port's calibration file for ``serve/strategies.py``.

    python3 scripts/write_calibration.py [--out experiments/torch/kernel_calibration.json]

Writes ``kernel_bench.calibration_section`` (the one derivation, as
``benchmarks/kernel_bench.py --write-calibration`` derives the JAX
package's): the per-page data-plane constants from the bytes the port's
kernels move over the H100's memory rate (``roofline.analysis.HBM_BW``):

* ``checksum_bw_Bps`` — a page and its checksum, 4,100 bytes a page;
* ``publish_sweep_page_s`` — the one-pass publish kernel's bytes
  (``chip_smoke.publish_bound``) at the bench's canonical workload (65,536
  pages, a third zero, half of the rest hot), a page;
* ``preinstall_page_s`` — a verified row-list install of a 16,384-page
  chunk (``chip_smoke.restore_rows_bytes``), a page.

Only ``checksum_bw_Bps`` moves a modeled number today.  No cost model, in
the port or in the JAX package, reads the other two: they are written so
that the file carries the same keys as the JAX package's calibration file,
and a model that prices the sweeps finds them measured the same way.

The file records the card's ``nvidia-smi`` name and power limit; run it on
the card.  Exits non-zero where ``nvidia-smi`` is missing.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "experiments" / "torch" /
                                          "kernel_calibration.json"))
    args = ap.parse_args()
    import chip_smoke as cs
    import kernel_bench

    cal = kernel_bench.calibration_section(kernel_bench.modeled_section(), cs.card_line())
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(cal, indent=2) + "\n")
    print(json.dumps(cal))
    return 0


if __name__ == "__main__":
    sys.exit(main())
