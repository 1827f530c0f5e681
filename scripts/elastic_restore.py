"""The port's twin of ``examples/elastic_restore.py``: checkpoint under one
mesh, restore re-sharded under another, and keep training — the snapshot's
offset-array indirection makes pages location-independent, so the restore
path is mesh-agnostic.

    PYTHONPATH=src python scripts/elastic_restore.py [--quick] [--device cuda|cpu]

The reference's flags: ``--quick`` trains xLSTM-125M reduced (vocab 512) at
32 tokens, batch 4, 2 + 2 steps; without it Qwen2.5-14B reduced at 64
tokens, batch 8, 5 + 5 steps.  Phase 1 trains and publishes the state
(``save_checkpoint``); phase 2 restores it through a new ``Orchestrator``,
places the parameters on a (1, 1) mesh with ``reshard`` (DTensors, whose
local tensors train on) and trains the same number of steps again.  The
pool's arenas are sized to the train state (``launch.pools``) instead of the
reference's 1 + 2 GiB of host arrays.  ``run`` is what ``chip_smoke.py``
calls at xLSTM-125M's full width.
"""
import argparse
import sys
import time

import torch

from repro_torch.checkpoint.ckpt import reshard, restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import HierarchicalPool, Orchestrator, PoolMaster
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch.mesh import host_mesh
from repro_torch.launch.pools import pool_capacities
from repro_torch.models.model_zoo import build
from repro_torch.sharding.partition import param_specs
from repro_torch.train.trainstep import TrainState, init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ModelConfig, seq_len: int, batch: int, steps: int, device="cuda",
        state: TrainState = None, master: PoolMaster = None, scatter_fn=None,
        prefetch_cold: bool = False) -> dict:
    """Phase 1 (``steps`` steps, publish), restore, ``reshard`` onto a (1, 1)
    mesh, phase 2 (``steps`` more).  ``state`` is the starting train state
    (``init_train_state(model, 0)`` when None); ``master`` the pool master
    to publish through (one sized to the train state when None);
    ``scatter_fn`` and ``prefetch_cold`` the restoring orchestrator's (the
    example's takes the defaults: every cold page demand-paged by the touch
    loop of ``restore_checkpoint``).  Returns the losses of both
    phases, the checkpoint and restore stats, the parameters as they were
    checkpointed (a copy), the placed ones (DTensors, their local tensors
    trained on in place by phase 2), whether those were bit-equal to the
    checkpointed ones before phase 2, and the phases' walls."""
    model = build(cfg, device=device)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch))
    step = make_train_step(model)

    def train(state, first):
        losses = []
        t0 = time.perf_counter()
        for i in range(first, first + steps):
            b = {k: torch.from_numpy(v).to(model.device) for k, v in data.batch_at(i).items()}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        _sync(model.device)
        return state, losses, time.perf_counter() - t0

    # phase 1: the "big mesh" run (one device here; the dry run covers the
    # 256- and 512-rank meshes)
    if state is None:
        state = init_train_state(model, 0)
    state, losses1, wall1 = train(state, 0)
    print(f"phase1 loss={losses1[-1]:.3f} — checkpointing")

    if master is None:
        master = PoolMaster(HierarchicalPool(*pool_capacities(cfg, moments=True),
                                             device=model.device))
    template = {"params": state.params, "opt": state.opt}
    t0 = time.perf_counter()
    _, save_stats = save_checkpoint(master, "elastic", template, step=steps)
    _sync(model.device)
    publish_s = time.perf_counter() - t0
    checkpointed = tree_map(lambda p: p.detach().clone(), state.params)

    # phase 2: restore on a different host and mesh ("scale-down" re-shard)
    orch = Orchestrator("new-fleet-host", master.pool, master.catalog,
                        prefetch_cold=prefetch_cold,
                        **({} if scatter_fn is None else {"scatter_fn": scatter_fn}))
    restored, stats = restore_checkpoint(orch, "elastic", template)
    with host_mesh(1, 1, device=model.device.type) as mesh:
        placed = reshard(restored["params"], mesh, param_specs(restored["params"]))
        print(f"restored step={stats['meta']['step']} and re-sharded onto "
              f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} — "
              f"time-to-hot={stats['time_to_hot_s'] * 1e3:.1f}ms")
        local = tree_map(lambda p: p.to_local(), placed)
        bit_equal = all(
            a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(tree_leaves(checkpointed), tree_leaves(local)))
        state2, losses2, wall2 = train(TrainState(local, restored["opt"]), steps)
    print(f"phase2 (post-reshard) loss={losses2[-1]:.3f} — training continued ✓")
    return {"losses1": losses1, "losses2": losses2, "save_stats": save_stats,
            "restore_stats": stats, "checkpointed": checkpointed, "placed": placed,
            "reshard_bit_equal": bit_equal, "state": state2,
            "walls": {"phase1_s": wall1, "publish_s": publish_s, "phase2_s": wall2}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="smaller arch/batch, 2+2 steps (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    arch = "xlstm-125m" if args.quick else "qwen2.5-14b"
    cfg = get_config(arch).reduced(vocab=512)
    run(cfg, seq_len=32 if args.quick else 64, batch=4 if args.quick else 8,
        steps=2 if args.quick else 5, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
