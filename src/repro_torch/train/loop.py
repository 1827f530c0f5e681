"""Training loop with Aquifer fault tolerance, the twin of the JAX package's
``train/loop.py``.

* periodic checkpoint publish: asynchronous (the publish runs on a thread
  over a host copy of the state, taken before training goes on: the step
  updates the state in place) or blocking (published from the state as it
  lies, with no copy: the publish copies it into its image first);
* crash/restart recovery: ``run(resume=True)`` borrows the latest snapshot
  and resumes from its step counter (the data pipeline's skip-ahead is
  O(1), so the restored run replays the exact batch stream);
* straggler-tolerant restore: parameters are the hot set, optimizer moments
  are demand-paged from the cold tier.

The step runs eagerly (CUDA graphs are ROADMAP A11b's).  The host copy of
an asynchronous checkpoint costs host memory, not device memory: at full
width the state is 12 B a parameter, and a device clone beside the image,
the publish's output and both tiers would not fit one card.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from ..checkpoint.ckpt import restore_checkpoint, save_checkpoint
from ..core import HierarchicalPool, Orchestrator, PoolMaster
from ..data.pipeline import SyntheticLMData
from ..models.model_zoo import Model
from ..tree import tree_map
from .trainstep import TrainState, init_train_state, make_train_step


@dataclasses.dataclass
class LoopConfig:
    """Training-loop schedule (total steps and checkpoint cadence)."""

    steps: int = 50
    ckpt_every: int = 20
    ckpt_name: str = "train-ckpt"
    async_checkpoint: bool = True
    log_every: int = 10


class Trainer:
    """Runs the train step over the data stream, checkpointing into the pool."""

    def __init__(
        self,
        model: Model,
        data: SyntheticLMData,
        master: Optional[PoolMaster] = None,
        orch: Optional[Orchestrator] = None,
        loop_cfg: LoopConfig = LoopConfig(),
        train_step: Optional[Callable] = None,
        seed: int = 0,
    ):
        self.model = model
        self.data = data
        pool = master.pool if master else HierarchicalPool(device=model.device)
        self.master = master or PoolMaster(pool)
        self.orch = orch or Orchestrator("trainer-host", self.master.pool, self.master.catalog)
        self.loop_cfg = loop_cfg
        self.train_step = train_step or make_train_step(model)
        self.seed = seed
        self.metrics_log: List[Dict] = []
        self._ckpt_thread: Optional[threading.Thread] = None
        self.ckpt_stats: List[Dict] = []

    # -- checkpointing -------------------------------------------------------
    def _publish(self, state: TrainState, step: int) -> None:
        _, stats = save_checkpoint(
            self.master, self.loop_cfg.ckpt_name,
            {"params": state.params, "opt": state.opt}, step,
        )
        stats["step"] = step
        self.ckpt_stats.append(stats)

    def checkpoint(self, state: TrainState, step: int, block: bool = False) -> None:
        if self.loop_cfg.async_checkpoint and not block:
            # the next step updates the state in place: copy it off first
            state_host = tree_map(lambda t: t.detach().to("cpu", copy=True), state)
            self.join()
            self._ckpt_thread = threading.Thread(
                target=self._publish, args=(state_host, step), daemon=True
            )
            self._ckpt_thread.start()
        else:
            self._publish(state, step)

    def join(self) -> None:
        """Wait for the checkpoint in flight, if any."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None

    def try_restore(self, template: TrainState):
        """-> (state, start_step, stats) — the template and step 0 if no
        snapshot is published."""
        try:
            restored, stats = restore_checkpoint(
                self.orch, self.loop_cfg.ckpt_name,
                {"params": template.params, "opt": template.opt},
            )
            state = TrainState(restored["params"], restored["opt"])
            return state, int(stats["meta"]["step"]), stats
        except FileNotFoundError:
            return template, 0, None

    # -- main loop -------------------------------------------------------------
    def run(self, state: Optional[TrainState] = None, resume: bool = False):
        if state is None:
            state = init_train_state(self.model, self.seed)
        start = 0
        if resume:
            state, start, rstats = self.try_restore(state)
            if rstats:
                self.metrics_log.append({"event": "restored", "step": start, **{
                    k: rstats[k] for k in ("time_to_hot_s", "time_to_full_s")}})
        t0 = time.perf_counter()
        device = self.model.device
        for step in range(start, self.loop_cfg.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in self.data.batch_at(step).items()}
            state, metrics = self.train_step(state, batch)
            if step % self.loop_cfg.log_every == 0 or step == self.loop_cfg.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, wall_s=time.perf_counter() - t0)
                self.metrics_log.append(m)
            if self.loop_cfg.ckpt_every and (step + 1) % self.loop_cfg.ckpt_every == 0:
                self.checkpoint(state, step + 1)
        self.join()
        return state
