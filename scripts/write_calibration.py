#!/usr/bin/env python3
"""Write the port's calibration file for ``serve/strategies.py``.

    python3 scripts/write_calibration.py [--out experiments/torch/kernel_calibration.json]

Derives the per-page data-plane constants the way
``benchmarks/kernel_bench.py --write-calibration`` derives the JAX
package's, from the bytes the port's kernels move per page over the H100's
memory rate (``chip_smoke.HBM_BYTES_PER_S``, the rate of the bounds in
PERF.md):

* ``checksum_bw_Bps`` — a page and its checksum, 4,100 bytes a page;
* ``publish_sweep_page_s`` — ``chip_smoke.publish_bound``'s bytes at the
  bench's canonical workload (65,536 pages, a third zero, half of the rest
  hot), a page;
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

MODEL_N = 65536                       # benchmarks/kernel_bench.py's canonical workload
MODEL_ZERO = MODEL_N // 3
MODEL_CHUNK = 16384


def calibration(card: str) -> dict:
    import chip_smoke as cs

    nnz = MODEL_N - MODEL_ZERO
    publish_bytes = cs.publish_bound(MODEL_N, nnz)[2]
    preinstall_bytes = cs.restore_rows_bytes(MODEL_CHUNK)
    rate = cs.HBM_BYTES_PER_S
    return {
        "written_by": "scripts/write_calibration.py",
        "note": "per-page data-plane costs at the H100 memory rate for the bytes the "
                "port's kernels move; serve/strategies.py reads `constants` at import",
        "card": card,
        "platform": {"hbm_bw_Bps": rate},
        "per_page": {
            "checksum_bytes": cs.PAGE + 4,
            "publish_sweep_bytes": publish_bytes / MODEL_N,
            "preinstall_bytes": preinstall_bytes / MODEL_CHUNK,
        },
        "constants": {
            "checksum_bw_Bps": cs.PAGE / ((cs.PAGE + 4) / rate),
            "publish_sweep_page_s": publish_bytes / MODEL_N / rate,
            "preinstall_page_s": preinstall_bytes / MODEL_CHUNK / rate,
        },
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "experiments" / "torch" /
                                          "kernel_calibration.json"))
    args = ap.parse_args()
    import chip_smoke as cs

    cal = calibration(cs.card_line())
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(cal, indent=2) + "\n")
    print(json.dumps(cal))
    return 0


if __name__ == "__main__":
    sys.exit(main())
