"""The port's twin of ``examples/quickstart.py``: train a tiny LM, publish
its state to the hierarchical pool, warm-restore it on another "host", and
serve tokens from the restored instance.

    PYTHONPATH=src python scripts/quickstart.py [--device cuda|cpu]

The reference's config (``qwen2.5-14b`` reduced, vocab 512), data (64
tokens, batch 8) and schedule (30 steps, an asynchronous checkpoint every
15).  The pool's arenas are sized to the train state (``launch.pools``)
instead of the reference's 0.5 + 1 GiB of host arrays.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.configs.base import get_config
from repro_torch.core import HierarchicalPool, Orchestrator, PoolMaster
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch.pools import pool_capacities
from repro_torch.models.model_zoo import build
from repro_torch.serve.engine import ServerInstance
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.tree import tree_leaves


def run(device="cuda", master=None) -> dict:
    """Train, checkpoint, restore on another host and generate; returns the
    losses, the checkpoint and restore stats and the generated tokens.  A
    ``master`` may be given (its pool on ``device``)."""
    # 1) a tiny same-family config of an assigned arch
    cfg = get_config("qwen2.5-14b").reduced(vocab=512)
    model = build(cfg, device=device)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8))

    # 2) shared pod infrastructure: two-tier pool + pool master
    if master is None:
        master = PoolMaster(HierarchicalPool(*pool_capacities(cfg, moments=True),
                                             device=model.device))
    pool = master.pool

    # 3) train a few steps with periodic Aquifer checkpoints
    trainer = Trainer(model, data, master=master,
                      loop_cfg=LoopConfig(steps=30, ckpt_every=15, log_every=10))
    state = trainer.run()
    losses = [(m.get("step"), round(m.get("loss", 0), 3))
              for m in trainer.metrics_log if "loss" in m]
    print("train metrics:", losses)
    print("checkpoint composition:", trainer.ckpt_stats[-1])

    # 4) warm restore on a different host (borrow → clflush → pre-install hot
    #    set → demand-page cold pages from the RDMA tier)
    orch = Orchestrator("other-host", pool, master.catalog)
    restored, stats = restore_checkpoint(
        orch, trainer.loop_cfg.ckpt_name,
        {"params": state.params, "opt": state.opt})
    print(f"restored step={stats['meta']['step']} "
          f"time-to-hot={stats['time_to_hot_s']*1e3:.1f}ms "
          f"time-to-full={stats['time_to_full_s']*1e3:.1f}ms")
    for a, b in zip(tree_leaves(state.params), tree_leaves(restored["params"])):
        if not torch.equal(a, b):
            raise AssertionError("restored params differ from the trained ones")
    print("restored params are bit-identical ✓")

    # 5) serve from the restored weights
    inst = ServerInstance(model, restored["params"], model.init_caches(None, 1, 64), 64)
    prompt = torch.tensor([[5, 17, 42]], dtype=torch.int32)
    tokens = inst.generate(prompt, 12)
    print("generated:", tokens[0].tolist())
    return {"losses": [m["loss"] for m in trainer.metrics_log if "loss" in m],
            "ckpt_stats": trainer.ckpt_stats, "restore_stats": stats,
            "tokens": np.asarray(tokens), "state": state, "restored": restored}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
