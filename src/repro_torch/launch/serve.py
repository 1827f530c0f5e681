"""Serving launcher, the twin of the JAX package's ``launch/serve.py``:
warm-restore an arch from the pool (publishing it first) and serve batched
greedy-decoding requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b --requests 4

``--device`` (default ``cuda``) places the model, the skeleton and the pool;
the pool's arenas are sized to the parameters (``launch.pools``).
"""
import argparse
import sys
import time

import numpy as np
import torch

from ..checkpoint.ckpt import save_checkpoint
from ..configs.base import all_arch_names, get_config
from ..core import HierarchicalPool, Orchestrator, PoolMaster
from ..models.model_zoo import build
from ..serve.coldstart import SkeletonPool, restore_server
from .pools import pool_capacities


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b", choices=all_arch_names())
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced(vocab=2048)
    if cfg.is_encdec:
        print("enc-dec serving requires encoder features; see examples/")
        return 2
    model = build(cfg, device=args.device)
    params = model.init(0)

    pool = HierarchicalPool(*pool_capacities(cfg, moments=False), device=model.device)
    master = PoolMaster(pool)
    _, stats = save_checkpoint(master, cfg.name, {"params": params}, step=0)
    print(f"published {cfg.name}: {stats['total_pages']} pages "
          f"(hot={stats['hot']} cold={stats['cold']} zero={stats['zero']})")

    orch = Orchestrator("serve-host", pool, master.catalog)
    sp = SkeletonPool(cfg, batch=args.requests, max_len=args.max_len,
                      target_size=1, background=False, device=model.device)
    t0 = time.perf_counter()
    out = restore_server(orch, cfg.name, sp.claim(), params)
    st = out["stats"]
    print(f"warm restore: hot={st['time_to_hot_s']*1e3:.0f}ms "
          f"full={st['time_to_full_s']*1e3:.0f}ms "
          f"(modeled pool time {sum(st['modeled'].values())*1e3:.2f}ms)")

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (args.requests, args.prompt_len))
                               .astype(np.int32))
    toks = out["instance"].generate(prompts, args.gen_tokens)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for i in range(args.requests):
        print(f"  req{i}: {toks[i].tolist()}")
    print(f"served {args.requests} requests x {args.gen_tokens} tokens "
          f"in {dt:.2f}s wall on {model.device}")
    sp.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
