"""The port's twin of ``examples/train_e2e.py``: end-to-end training with
Aquifer fault tolerance.

    PYTHONPATH=src python scripts/train_e2e.py                      # demo
    PYTHONPATH=src python scripts/train_e2e.py --preset 100m        # ~124M
    PYTHONPATH=src python scripts/train_e2e.py --resume             # restart
    PYTHONPATH=src python scripts/train_e2e.py --crash-at 20        # crash + restore

The reference's presets and flags, plus ``--device`` (default ``cuda``).
A mid-run simulated crash + restore is exercised with ``--crash-at N``.  The
pool's arenas are sized to the train state (``launch.pools``).
"""
import argparse
import sys
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.core import HierarchicalPool, PoolMaster
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch.pools import pool_capacities
from repro_torch.models.model_zoo import build
from repro_torch.train.loop import LoopConfig, Trainer

PRESETS = {
    "demo": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, d_ff=1024,
                 vocab=2048, d_head=64, seq=128, batch=8, steps=60),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                 vocab=50304, d_head=64, seq=512, batch=8, steps=300),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="demo", choices=list(PRESETS))
    ap.add_argument("--arch", default="qwen2.5-14b",
                    help="assigned arch whose family the preset reduces")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="simulate a crash after N steps, then auto-restore")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    steps = args.steps or p["steps"]
    cfg = get_config(args.arch).reduced(
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"], vocab=p["vocab"],
        d_head=p["d_head"], scan_layers=True)
    model = build(cfg, device=args.device)
    n_params = cfg.param_count()
    print(f"arch={cfg.name} family={cfg.family} params≈{n_params/1e6:.0f}M "
          f"steps={steps} device={model.device}")

    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=p["seq"],
                                      global_batch=p["batch"]))
    pool = HierarchicalPool(*pool_capacities(cfg, moments=True), device=model.device)
    master = PoolMaster(pool)

    if args.crash_at:
        t1 = Trainer(model, data, master=master,
                     loop_cfg=LoopConfig(steps=args.crash_at,
                                         ckpt_every=max(1, args.crash_at // 2),
                                         log_every=10, async_checkpoint=False))
        t1.run()
        print(f"--- simulated crash after step {args.crash_at} ---")
        args.resume = True

    trainer = Trainer(model, data, master=master,
                      loop_cfg=LoopConfig(steps=steps, ckpt_every=50, log_every=10))
    t0 = time.perf_counter()
    state = trainer.run(resume=args.resume)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [(m["step"], round(m["loss"], 3)) for m in trainer.metrics_log if "loss" in m]
    print("loss curve:", losses)
    if trainer.ckpt_stats:
        s = trainer.ckpt_stats[-1]
        print(f"last checkpoint: {s['total_pages']} pages "
              f"(zero={s['zero']} hot={s['hot']} cold={s['cold']}) "
              f"publish={s['publish_s']*1e3:.0f}ms (async, off critical path)")
    print(f"wall={wall:.1f}s  tokens/s={steps*p['seq']*p['batch']/wall:,.0f} "
          f"on {model.device}")
    return {"trainer": trainer, "state": state, "losses": losses}


if __name__ == "__main__":
    main()
    sys.exit(0)
