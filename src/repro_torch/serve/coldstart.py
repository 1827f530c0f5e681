"""Serverless model serving with Aquifer cold-start mitigation.

`SkeletonPool` is the MicroVM-pool analogue (§3.5): pre-created server
skeletons with the expensive host resources already provisioned — the
built model and pre-allocated KV caches on the device — so an incoming
invocation only needs its weights installed (borrow → flush → pre-install
→ resume) instead of paying the allocation on the critical path.  The JAX
package also warms its jitted decode step here; this engine runs its
decode step eagerly, so there is no compiled step to warm.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Optional

from ..checkpoint.ckpt import restore_checkpoint
from ..configs.base import ModelConfig
from ..core import Orchestrator
from ..core.clock import Clock, REAL_CLOCK
from ..models.model_zoo import Model, build
from .engine import ServerInstance


@dataclasses.dataclass
class Skeleton:
    """Pre-provisioned resources for one instance (no weights yet)."""

    cfg: ModelConfig
    model: Model
    caches: Any                 # pre-allocated decode state
    batch: int
    max_len: int
    # stamped from the owning SkeletonPool's injected Clock (monotonic
    # seconds): skeleton-age accounting stays deterministic under a virtual
    # clock
    created_at: float = 0.0


class SkeletonPool:
    """Continuously replenished pool of pre-created skeletons (§3.5) on
    ``device``."""

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int,
                 target_size: int = 2, background: bool = True,
                 clock: Optional[Clock] = None, device="cuda"):
        self.clock = clock or REAL_CLOCK
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.target_size = target_size
        self.model = build(cfg, device=device)
        self._q: "queue.Queue[Skeleton]" = queue.Queue()
        self.stats = {"claimed": 0, "created_on_demand": 0, "replenished": 0}
        # signaled by claim()/close(); the replenish thread blocks here while
        # the pool is full instead of polling the stop event
        self._cond = threading.Condition()
        for _ in range(target_size):
            self._q.put(self._make())
        self._bg = background
        self._stop = threading.Event()
        if background:
            self._t = threading.Thread(target=self._replenish_loop, daemon=True)
            self._t.start()

    def _make(self) -> Skeleton:
        caches = self.model.init_caches(None, self.batch, self.max_len)
        return Skeleton(self.cfg, self.model, caches, self.batch, self.max_len,
                        created_at=self.clock.monotonic())

    def _need_work(self) -> bool:
        return self._stop.is_set() or self._q.qsize() < self.target_size

    def _replenish_loop(self):
        while True:
            with self._cond:
                # block until a claim drains the queue or close() asks us to
                # exit: no periodic wakeups while the pool is full.  claim()
                # and close() notify under the same condition, so the check-
                # then-wait cannot lose a wakeup.
                while not self._need_work():
                    self.clock.cv_wait_for(self._cond, self._need_work, None)
                if self._stop.is_set():
                    return
            # build OUTSIDE the condition: a skeleton build must not block
            # claim()/close() from signaling
            self._q.put(self._make())
            self.stats["replenished"] += 1

    def claim(self) -> Skeleton:
        self.stats["claimed"] += 1
        try:
            sk = self._q.get_nowait()
        except queue.Empty:
            self.stats["created_on_demand"] += 1
            return self._make()
        with self._cond:
            self._cond.notify()
        return sk

    def close(self, timeout_s: float = 10.0):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._bg:
            # the loop re-checks _stop only between _make() calls
            self._t.join(timeout=timeout_s)


def restore_server(
    orch: Orchestrator,
    snapshot_name: str,
    skeleton: Skeleton,
    params_template,
) -> Dict[str, Any]:
    """Aquifer warm restore into a claimed skeleton.

    Returns ``{"instance": ServerInstance, "stats": {...}, "state": ...}``
    with time to hot (params pre-installed from CXL) and time to full
    recorded; ``state`` is the restored tree, tensors on the pool's device
    that view the restored image (the instance holds its own compute-dtype
    copy of the params).
    """
    template = ({"params": params_template}
                if "params" not in params_template else params_template)
    state, stats = restore_checkpoint(orch, snapshot_name, template)
    inst = ServerInstance(skeleton.model, state["params"], skeleton.caches, skeleton.max_len)
    return {"instance": inst, "stats": stats, "state": state}
