"""Training launcher, the twin of the JAX package's ``launch/train.py``: any
ported arch, Aquifer fault tolerance on.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b --resume

By default the arch's reduced() config trains (same family and code paths);
``--full`` takes the published config.  ``--device`` (default ``cuda``)
places the model and the pool; ``--device cpu`` runs the plain versions.
The pool's arenas are sized to the train state (``launch.pools``).
"""
import argparse
import sys

from ..configs.base import all_arch_names, get_config
from ..core import HierarchicalPool, PoolMaster
from ..data.pipeline import DataConfig, SyntheticLMData
from ..models.model_zoo import build
from ..train.loop import LoopConfig, Trainer
from .pools import pool_capacities


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b", choices=all_arch_names())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="use the full published config (real hardware only)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_config(args.arch).reduced(vocab=2048)
    if cfg.is_encdec:
        print("enc-dec arch: use examples/ for the seq2seq driver; training "
              "the decoder-only path is not defined for", cfg.name)
        return 2
    model = build(cfg, device=args.device)
    print(f"arch={cfg.name} family={cfg.family} params≈{cfg.param_count()/1e6:.1f}M "
          f"device={model.device}")

    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch))
    master = PoolMaster(HierarchicalPool(*pool_capacities(cfg, moments=True),
                                         device=model.device))
    trainer = Trainer(model, data, master=master,
                      loop_cfg=LoopConfig(steps=args.steps,
                                          ckpt_every=args.ckpt_every,
                                          log_every=10,
                                          ckpt_name=f"{cfg.name}-train"))
    trainer.run(resume=args.resume)
    for m in trainer.metrics_log:
        if "loss" in m:
            print(f"  step {m['step']:>5d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.2f}")
    if trainer.ckpt_stats:
        s = trainer.ckpt_stats[-1]
        print(f"checkpoint: {s['total_pages']} pages zero={s['zero']} "
              f"hot={s['hot']} cold={s['cold']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
