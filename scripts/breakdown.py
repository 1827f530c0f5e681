#!/usr/bin/env python3
"""Fig. 6 analogue on the PyTorch port: invocation-time breakdown on
chameleon across the five restore configurations, at 32 concurrent
restores (the paper's setting).

    PYTHONPATH=src python scripts/breakdown.py [--device cuda|cpu]

The port's twin of ``benchmarks/breakdown.py``.  The workload is
``scripts/workloads.py``'s chameleon (reduced qwen2.5-14b, parameters from
the port's seeded init; the modeled keys depend only on which pages are
zero, hot or cold, which is the reference's).  Also checks end-to-end
restore correctness with real data movement on ``device``: the snapshot is
published through the fused sweep and restored through ``Orchestrator``
(run-coalesced hot pre-install, background cold-extent prefetch, then every
absent page touched), and must equal the image (``torch.equal``).  Times
are modeled seconds (the paper's cost model).  Results go to
``experiments/torch/breakdown.json`` (the committed CPU
runs; ``build/benches/`` with another ``--device``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from repro_torch.core import HierarchicalPool, Orchestrator, PoolMaster  # noqa: E402
from repro_torch.kernels import make_fused_publish_fn  # noqa: E402
from repro_torch.serve.strategies import (  # noqa: E402
    STRATEGIES,
    hot_preinstall_time,
    run_strategy,
)
from workloads import get_workload  # noqa: E402

OUT = ROOT / "experiments" / "torch"


def run(workload: str = "chameleon", concurrency: int = 32, device="cuda") -> dict:
    bw = get_workload(workload, device=device)
    spec = bw.spec()

    rows = {}
    for strat in STRATEGIES:
        res = run_strategy(strat, spec, concurrency=concurrency)
        rows[strat] = {**res.breakdown(), "stats": res.stats}
    # per-page (non-coalesced) Aquifer for the run-batching ablation
    res_pp = run_strategy("aquifer", spec, concurrency=concurrency, batched=False)
    rows["aquifer_perpage"] = {**res_pp.breakdown(), "stats": res_pp.stats}

    # hot pre-install, per-instance serial path: the per-run vs per-page
    # modeled-time comparison the batched serving design targets
    pre_batched = hot_preinstall_time(spec, batched=True)
    pre_perpage = hot_preinstall_time(spec, batched=False)
    hot_preinstall = {
        "per_page_s": pre_perpage,
        "batched_s": pre_batched,
        "speedup": pre_perpage / max(pre_batched, 1e-12),
    }

    # real-data correctness: publish + borrow + full restore (run-coalesced
    # hot pre-install + background cold-extent prefetch), bit-compare
    pool = HierarchicalPool(cxl_capacity=1 << 30, rdma_capacity=2 << 30, device=device)
    master = PoolMaster(pool, publish_fn=make_fused_publish_fn())
    master.publish(workload, bw.image, bw.profile.working_set)
    orch = Orchestrator("bench-host", pool, master.catalog, use_async_rdma=True,
                        prefetch_cold=True)
    ri = orch.restore(workload)
    assert ri is not None
    ri.engine.wait_prefetch_idle()
    for page in range(ri.instance.image.total_pages):
        if not ri.instance.present[page]:
            ri.engine.access(page)
    bit_identical = bool(torch.equal(ri.instance.image.buf, bw.image.buf))
    inst_stats = dict(ri.instance.stats)
    prefetch_stats = dict(ri.engine.prefetch_stats)
    ledger = {k: v for k, v in ri.ledger.seconds.items()}
    ri.shutdown()
    orch.close()

    fc, aq = rows["firecracker"]["total"], rows["aquifer"]["total"]
    fs = rows["faasnap"]["total"]
    out = {
        "workload": workload,
        "concurrency": concurrency,
        "breakdown": rows,
        "hot_preinstall": hot_preinstall,
        "install_cost_ratio_fc_over_aquifer":
            rows["firecracker"]["exec_install"] / max(rows["aquifer"]["exec_install"], 1e-12),
        "speedup_vs_firecracker": fc / aq,
        "speedup_vs_faasnap": fs / aq,
        "restore_bit_identical": bit_identical,
        "restore_instance_stats": inst_stats,
        "restore_prefetch_stats": prefetch_stats,
        "restore_modeled_ledger_s": ledger,
        "paper": {"speedup_vs_firecracker": 2.12, "speedup_vs_faasnap": 1.19,
                  "install_cost_ratio": 187.0},
    }
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "breakdown.json").write_text(json.dumps(out, indent=2))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the image's and the pool's device")
    args = ap.parse_args()
    if args.device != "cpu":        # experiments/torch/ holds the CPU runs
        global OUT
        OUT = ROOT / "build" / "benches"
    out = run(device=args.device)
    print(f"breakdown on {out['workload']} @ {out['concurrency']} concurrent (modeled s):")
    print(f"{'strategy':12s}{'setup':>9s}{'prefetch':>9s}{'install':>9s}{'compute':>9s}{'total':>9s}")
    for strat, r in out["breakdown"].items():
        print(f"{strat:12s}{r['setup']:9.4f}{r['prefetch']:9.4f}{r['exec_install']:9.4f}"
              f"{r['compute']:9.4f}{r['total']:9.4f}")
    print(f"Aquifer speedup vs firecracker: {out['speedup_vs_firecracker']:.2f}x (paper 2.12x)")
    print(f"Aquifer speedup vs faasnap:     {out['speedup_vs_faasnap']:.2f}x (paper 1.19x)")
    print(f"install-cost ratio fc/aquifer:  {out['install_cost_ratio_fc_over_aquifer']:.0f}x (paper 187x)")
    hp = out["hot_preinstall"]
    print(f"hot pre-install (per-instance): per-page {hp['per_page_s']*1e3:.2f} ms "
          f"vs batched {hp['batched_s']*1e3:.2f} ms -> {hp['speedup']:.2f}x")
    print(f"bit-identical restore: {out['restore_bit_identical']}")
    return 0 if out["restore_bit_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
