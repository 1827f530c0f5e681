"""Queue-depth host autoscaling for the fleet driver.

The pod adds restore hosts when the backlog per alive host crosses
``up_queue_per_host`` and retires *empty* hosts (no running work, no queue,
no warm instances) when it falls below ``down_queue_per_host``.  Decisions
are hysteretic — the two thresholds are separated and every action starts a
cooldown window — so a bursty arrival process (the ON/OFF traces) does not
thrash host count.  Purely deterministic: state is (last action time, host
count), inputs are the modeled clock and queue depth.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class QueueAutoscaler:
    """Queue-depth host autoscaling policy (grow on backlog, shrink idle)."""

    min_hosts: int = 4
    max_hosts: int = 256
    up_queue_per_host: float = 8.0     # backlog/host that triggers scale-up
    down_queue_per_host: float = 1.0   # backlog/host that allows scale-down
    step_frac: float = 0.25            # grow/shrink by this fraction of pod
    cooldown_s: float = 2.0
    _last_action_t: float = dataclasses.field(default=-1e18, init=False)

    def decide(self, now: float, queued: int, n_alive: int) -> int:
        """Return the host-count delta (+k grow, -k shrink candidates, 0
        hold).  The driver only retires hosts that are actually empty, so a
        negative return is a ceiling, not a command."""
        if n_alive <= 0:
            self._last_action_t = now
            return max(1, self.min_hosts)
        if now - self._last_action_t < self.cooldown_s:
            return 0
        per_host = queued / n_alive
        step = max(1, int(n_alive * self.step_frac))
        if per_host > self.up_queue_per_host and n_alive < self.max_hosts:
            self._last_action_t = now
            return min(step, self.max_hosts - n_alive)
        if per_host < self.down_queue_per_host and n_alive > self.min_hosts:
            self._last_action_t = now
            return -min(step, n_alive - self.min_hosts)
        return 0
