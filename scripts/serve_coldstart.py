#!/usr/bin/env python3
"""Serverless model serving with Aquifer cold-start mitigation, on the
PyTorch port.

    PYTHONPATH=src python scripts/serve_coldstart.py [--workload chameleon]
        [--concurrency 32] [--quick] [--device cuda|cpu]

The port's twin of ``examples/serve_coldstart.py``.  Compares the five
restore strategies (§5.1.3, modeled seconds of the paper's cost model) on
a workload's image (``scripts/workloads.py``) at ``--concurrency``, then
does a real warm restore on ``--device``: the workload architecture's
reduced model (vocab 512) from a seeded init is published by
``save_checkpoint``, restored by ``restore_server`` into a skeleton
claimed from a ``SkeletonPool``, and serves tokens through ``generate``.
``--quick`` takes pyaes (xlstm-125m, the smallest image) at concurrency 8
and serves 2 tokens.  The pool's arenas are sized to the model
(``launch.pools``) instead of the reference's 1 + 2 GiB.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from repro_torch.checkpoint.ckpt import save_checkpoint  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import HierarchicalPool, Orchestrator, PoolMaster  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.pools import pool_capacities  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.serve.coldstart import SkeletonPool, restore_server  # noqa: E402
from repro_torch.serve.strategies import STRATEGIES, run_strategy  # noqa: E402
from workloads import all_workloads, get_workload  # noqa: E402

PROMPT = [[1, 2, 3]]


def strategy_table(workload: str, concurrency: int, device="cuda") -> dict:
    """The workload's image, scale and the five strategies' breakdowns
    (modeled seconds) at ``concurrency``."""
    bw = get_workload(workload, device=device)
    spec = bw.spec()
    rows = {s: run_strategy(s, spec, concurrency=concurrency) for s in STRATEGIES}
    return {"arch": bw.wdef.arch, "image_mib": bw.image.buf.numel() / (1 << 20),
            "scale": spec.scale, "rows": {s: r.breakdown() for s, r in rows.items()},
            "speedup_vs_firecracker": rows["firecracker"].total_s / rows["aquifer"].total_s,
            "speedup_vs_faasnap": rows["faasnap"].total_s / rows["aquifer"].total_s}


def warm_restore(arch: str, n_tokens: int, device="cuda", params=None) -> dict:
    """Publish ``arch``'s reduced model (vocab 512), warm-restore it into a
    claimed skeleton and serve ``n_tokens`` greedy tokens of :data:`PROMPT`.
    ``params`` (nested dicts of numpy arrays) replaces the seeded init."""
    cfg = get_config(arch).reduced(vocab=512)
    if params is None:
        params = build(cfg, device=device).init(0)
    else:
        params = params_from_numpy(params, device=device)
    master = PoolMaster(HierarchicalPool(*pool_capacities(cfg, moments=False), device=device))
    save_checkpoint(master, "model", {"params": params}, step=0)
    orch = Orchestrator("serve-host", master.pool, master.catalog)
    sp = SkeletonPool(cfg, batch=1, max_len=64, target_size=1, background=False,
                      device=device)
    try:
        out = restore_server(orch, "model", sp.claim(), params)
        tokens = out["instance"].generate(torch.tensor(PROMPT, dtype=torch.int32), n_tokens)
    finally:
        sp.close()
        orch.close()
    master.delete("model")
    return {"stats": out["stats"], "tokens": tokens}


def run(workload: str = "chameleon", concurrency: int = 32, quick: bool = False,
        device="cuda", params=None) -> dict:
    """The strategy table and the warm restore; ``quick`` takes pyaes at
    concurrency 8 and 2 tokens, as the reference's ``--quick`` does."""
    if quick:
        workload, concurrency = "pyaes", 8
    table = strategy_table(workload, concurrency, device)
    served = warm_restore(table["arch"], 2 if quick else 8, device, params)
    return {"workload": workload, "concurrency": concurrency, **table, **served}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="chameleon", choices=all_workloads())
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--quick", action="store_true",
                    help="smallest workload, fewer tokens (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.workload, args.concurrency, args.quick, args.device)

    print(f"workload={out['workload']} arch={out['arch']} "
          f"image={out['image_mib']:.0f}MiB "
          f"(scaled to paper-size 1.5GiB instances, x{out['scale']:.1f})")
    print(f"\nrestore strategies @ concurrency={out['concurrency']} (modeled):")
    print(f"{'strategy':12s}{'setup':>9s}{'prefetch':>9s}{'install':>9s}{'total':>9s}")
    for s, b in out["rows"].items():
        print(f"{s:12s}{b['setup']:9.4f}{b['prefetch']:9.4f}{b['exec_install']:9.4f}"
              f"{b['total']:9.4f}")
    print(f"\nAquifer speedup: {out['speedup_vs_firecracker']:.2f}x "
          f"vs firecracker, {out['speedup_vs_faasnap']:.2f}x vs faasnap")
    st = out["stats"]
    print(f"\nwarm restore: time-to-hot={st['time_to_hot_s']*1e3:.1f}ms "
          f"time-to-full={st['time_to_full_s']*1e3:.1f}ms "
          f"(pre-installed {st['instance']['pre_installed']} hot pages, "
          f"{st['instance']['fault_rdma']} async RDMA cold faults)")
    print("served tokens:", out["tokens"][0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
