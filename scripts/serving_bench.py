#!/usr/bin/env python3
"""Restore-path microbenchmark on the PyTorch port: per-page against
run-coalesced batched serving.

    PYTHONPATH=src python scripts/serving_bench.py [--quick] [--workloads ...]
        [--device cuda|cpu]

The port's twin of ``benchmarks/serving_bench.py``.  For each workload
(``scripts/workloads.py``; the dense ones are ported) the snapshot is
published once through the fused sweep on ``device``, then restored twice
with fresh incoherent host views:

  per_page : one HostView read and one uffd.copy per 4 KiB page, one RDMA
             read per cold page;
  batched  : chunked CXL streaming over the compact hot region, one uffd
             ioctl per guest-contiguous run, one RDMA read per cold extent.

Both must equal the image (``torch.equal``); the batched path must never
model more time than the per-page path and must install exactly the same
bytes.  With ``zstandard`` installed the comparison also runs against a
zstd-compressed cold tier.  ``wall_s`` is a wall clock; every other time is
modeled.  Results go to ``experiments/torch/serving_bench.json`` (the
committed CPU runs; ``build/benches/`` with another ``--device``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from repro_torch.core import HierarchicalPool, PoolMaster, StateImage  # noqa: E402
from repro_torch.core.pool import TimeLedger  # noqa: E402
from repro_torch.core.serving import Instance, RestoreEngine  # noqa: E402
from repro_torch.core.snapshot import SnapshotReader, _zstd  # noqa: E402
from repro_torch.kernels import make_fused_publish_fn  # noqa: E402
from workloads import DENSE, get_workload  # noqa: E402

OUT = ROOT / "experiments" / "torch"


def _one_restore(pool, regions, image, mode: str) -> dict:
    batched = mode == "batched"
    ledger = TimeLedger()
    view = pool.host_view(f"bench-{mode}", ledger)
    reader = SnapshotReader(regions, view, pool.rdma)
    reader.invalidate_cxl()
    inst = Instance(StateImage.empty_like(image.manifest, device=image.device), ledger)
    eng = RestoreEngine(reader, inst, rdma_engine=None)

    t0 = time.perf_counter()
    eng.pre_install_hot(use_batch=batched)
    pre_s = {k: v for k, v in ledger.seconds.items()}
    eng.install_all_sync(use_batch=batched)
    if image.device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0

    return {
        "preinstall_modeled_s": pre_s.get("cxl_read", 0.0) + pre_s.get("uffd_copy", 0.0),
        "total_modeled_s": ledger.total(),
        "ledger_s": dict(ledger.seconds),
        "wall_s": wall_s,
        "bit_identical": bool(torch.equal(inst.image.buf, image.buf)),
        "bytes_installed": inst.stats["bytes_installed"],
        "cxl_bytes_read": view.stats["bytes_read"],
        "uffd_batches": inst.stats["uffd_batches"],
        "uffd_copies": inst.stats["uffd_copies"],
    }


def bench_workload(name: str, compress_cold: bool = False, device="cuda") -> dict:
    bw = get_workload(name, device=device)
    pool = HierarchicalPool(cxl_capacity=1 << 30, rdma_capacity=2 << 30, device=device)
    master = PoolMaster(pool, publish_fn=make_fused_publish_fn())
    regions = master.publish(name, bw.image, bw.profile.working_set,
                             compress_cold=compress_cold)
    modes = {m: _one_restore(pool, regions, bw.image, m)
             for m in ("per_page", "batched")}
    pp, bt = modes["per_page"], modes["batched"]
    row = {
        "workload": name,
        "cold_compressed": bool(regions.cold_compressed),
        "modes": modes,
        "preinstall_speedup": pp["preinstall_modeled_s"] / max(bt["preinstall_modeled_s"], 1e-12),
        "total_speedup": pp["total_modeled_s"] / max(bt["total_modeled_s"], 1e-12),
        "bit_identical_both": pp["bit_identical"] and bt["bit_identical"],
        "bytes_match": pp["bytes_installed"] == bt["bytes_installed"],
        "batched_not_slower": bt["total_modeled_s"] <= pp["total_modeled_s"] + 1e-12,
    }
    return row


def run(workloads=None, device="cuda") -> dict:
    """``workloads`` defaults to the four dense ones (the nine-workload run
    is ROADMAP A13b).  The compressed rows run where ``zstandard`` is
    installed."""
    names = list(workloads) if workloads else list(DENSE)
    rows = [bench_workload(n, device=device) for n in names]
    rows_z = ([bench_workload(n, compress_cold=True, device=device) for n in names]
              if _zstd else [])
    ok = all(r["bit_identical_both"] and r["bytes_match"] and r["batched_not_slower"]
             for r in rows + rows_z)
    out = {
        "rows": rows,
        "rows_compressed_cold": rows_z,
        "zstd_available": _zstd is not None,
        "all_bit_identical_and_not_slower": ok,
    }
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "serving_bench.json").write_text(json.dumps(out, indent=2))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="chameleon only")
    ap.add_argument("--workloads", nargs="*", default=None)
    ap.add_argument("--device", default="cuda", help="the images' and pools' device")
    args = ap.parse_args()
    if args.device != "cpu":        # experiments/torch/ holds the CPU runs
        global OUT
        OUT = ROOT / "build" / "benches"
    names = ["chameleon"] if args.quick else args.workloads
    out = run(names, device=args.device)
    print(f"{'workload':14s}{'pre pp(ms)':>11s}{'pre bt(ms)':>11s}{'x':>6s}"
          f"{'tot pp(ms)':>11s}{'tot bt(ms)':>11s}{'x':>6s}  ok")
    for r in out["rows"] + out["rows_compressed_cold"]:
        pp, bt = r["modes"]["per_page"], r["modes"]["batched"]
        tag = r["workload"] + ("+z" if r["cold_compressed"] else "")
        print(f"{tag:14s}{pp['preinstall_modeled_s']*1e3:11.2f}"
              f"{bt['preinstall_modeled_s']*1e3:11.2f}{r['preinstall_speedup']:6.2f}"
              f"{pp['total_modeled_s']*1e3:11.2f}{bt['total_modeled_s']*1e3:11.2f}"
              f"{r['total_speedup']:6.2f}  "
              f"{r['bit_identical_both'] and r['bytes_match'] and r['batched_not_slower']}")
    print(f"all bit-identical & batched never slower: {out['all_bit_identical_and_not_slower']}")
    return 0 if out["all_bit_identical_and_not_slower"] else 1


if __name__ == "__main__":
    sys.exit(main())
