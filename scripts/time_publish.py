#!/usr/bin/env python3
"""Time a checkout's publish sweep on one NVIDIA card at the 1.5 GiB image.

    python3 scripts/time_publish.py [--tree DIR] [--seed 0] [--out FILE]

The image is ``chip_smoke.py``'s (same seed, same pages).  ``--tree``
(default: this checkout) names the checkout whose ``fused_publish`` wrapper
is timed, so that two commits can be compared on one card in turns, one
process a turn (unpack the other with ``git archive`` under ``build/``).
Its output is first checked bit for bit against the plain version.  One
JSON line reports the card, the bound (``chip_smoke.publish_bound``) and
the times: ``wrapper_ms``, CUDA events around 10 back-to-back calls, host
read-backs inside the wrapper included; ``device_ms``, the device time of
one call's kernels, copies and memsets under ``torch.profiler`` (5 calls),
with each by name.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def time_tree(torch, cs, ops, ref, pm, ws) -> dict:
    from torch.profiler import ProfilerActivity, profile

    got = ops.fused_publish(pm, ws)
    for a, b in zip((got.zero_bitmap, got.checksums, got.hot, got.cold),
                    ref.fused_publish_ref(pm, ws)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("fused_publish differs from the plain version")
    nnz = got.hot.shape[0] + got.cold.shape[0]
    del got
    wrapper_ms = cs.cuda_ms(lambda: ops.fused_publish(pm, ws), iters=10)
    calls = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.fused_publish(pm, ws)
        torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA
    by_name = {e.key: e.self_device_time_total / 1e3 / calls
               for e in prof.key_averages() if e.device_type == dev}
    return {"non_zero": nnz, "wrapper_ms": wrapper_ms, "device_ms": sum(by_name.values()),
            "device_ms_by_name": by_name}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import chip_smoke as cs

    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch

    if not torch.cuda.is_available():
        print("time_publish: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.snapshot_fuse import ops, ref

    if not Path(ops.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"imported {ops.__file__}, not from {tree}")
    device = torch.device("cuda", 0)
    n = cs.PAPER_INSTANCE_PAGES
    buf, ws = cs.make_image(n, args.seed, device)
    pm = buf.view(n, cs.PAGE)
    build.build(["fused_publish"])
    row = time_tree(torch, cs, ops, ref, pm, ws)
    bound, by, _ = cs.publish_bound(n, row["non_zero"])
    row = {"card": cs.card_line(), "tree": str(tree), "pages": n, "bound_ms": bound,
           "bound_by": by, **row}
    line = json.dumps(row)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
