"""Discrete-event fleet-serving driver: traffic in, cold-start tail out.

``FleetDriver`` replays an arrival :class:`~repro_torch.fleet.arrivals.Trace`
against a pod of :class:`~repro_torch.fleet.placement.HostState` hosts on a
single event heap (the batched-serving loop idiom: pop the next completion
or arrival, update state, push the consequences).  Time is modeled — every
duration comes from a :class:`~repro_torch.fleet.model.RestoreProfile` priced
under the host's conditions at dispatch — and the injected
:class:`~repro_torch.sim.clock.VirtualClock` is advanced to each event so any
clock-reading component observes a consistent timeline.

Per invocation the driver resolves, in order:

1. **warm hit** — a kept-warm instance of the same function on any alive
   host with a free slot resumes in ``WARM_RESUME_S``;
2. **placement** — the :class:`PlacementScheduler` picks a host; with a
   free slot the restore starts, otherwise the invocation queues FIFO;
3. **restore pricing** — joining an in-flight same-snapshot fan-out group
   costs install-only and finishes with the group; a fresh restore pays
   ``profile.cold_start_s(conc, overlap)`` where ``conc`` counts the
   host's distinct active groups and ``overlap`` its chunk-cache coverage;
4. **keep-warm** — on completion, ``strategies.keepwarm_economics`` prices
   holding the instance for its expected inter-arrival gap against
   re-restoring; worthwhile instances stay resident until a warm hit or
   expiry.

Host crashes (``crash_at``) kill a host mid-trace: its queued and
in-flight invocations are re-placed on the survivors and restored from
scratch (pool state is durable; only the host's private mappings die).
An optional :class:`~repro_torch.fleet.autoscale.QueueAutoscaler` grows/shrinks
the pod on backlog.  Everything is deterministic per (trace, seed).
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.clock import Clock, REAL_CLOCK
from ..serve.strategies import WARM_RESUME_S, keepwarm_economics
from .arrivals import FunctionType, Trace
from .autoscale import QueueAutoscaler
from .model import RestoreProfile
from .placement import HostState, PlacementScheduler

# event kinds, ordered so same-timestamp events resolve deterministically:
# finish work before expiring warm instances before admitting new arrivals
EV_RESTORE_DONE = 0
EV_COMPUTE_DONE = 1
EV_WARM_EXPIRE = 2
EV_CRASH = 3
EV_ARRIVAL = 4

MODE_COLD = 0      # paid a full (possibly overlap-discounted) restore
MODE_JOIN = 1      # joined an in-flight fan-out group, install-only
MODE_WARM = 2      # resumed a kept-warm instance


_SUM_BLOCK = 8            # NumPy's pairwise-sum unroll
_SUM_LEAF = 128          # its pairwise block
_SUM_BUFFER = 8192       # its reduction buffer


def _pairwise_sum(x: np.ndarray) -> float:
    n = x.size
    if n < _SUM_BLOCK:
        res = 0.0
        for v in x.tolist():
            res += v
        return res
    if n <= _SUM_LEAF:
        m = n - n % _SUM_BLOCK
        r = np.cumsum(x[:m].reshape(-1, _SUM_BLOCK), axis=0)[-1].tolist()
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for v in x[m:].tolist():
            res += v
        return res
    n2 = n // 2
    n2 -= n2 % _SUM_BLOCK
    return _pairwise_sum(x[:n2]) + _pairwise_sum(x[n2:])


def float_sum(x) -> float:
    """``x.sum()`` of a float64 array, added in the order NumPy 2.0 adds
    it: pairwise sums (8 running sums per block of at most 128) inside
    buffers of 8,192 elements, the buffers summed in order.  Fixed here so
    that a summary does not depend on the NumPy build: NumPy 2.3 on an
    AVX-512 host adds in another order and can differ in the last bit."""
    x = np.ascontiguousarray(x, dtype=np.float64).reshape(-1)
    total = 0.0
    for s in range(0, x.size, _SUM_BUFFER):
        total += _pairwise_sum(x[s : s + _SUM_BUFFER])
    return total


def float_mean(x) -> float:
    """``x.mean()`` of a float64 array, added as :func:`float_sum` adds."""
    x = np.ascontiguousarray(x, dtype=np.float64).reshape(-1)
    return float_sum(x) / x.size


@dataclasses.dataclass
class FleetResult:
    """Per-invocation outcome arrays plus run-level counters."""

    arrival_s: np.ndarray        # trace arrival time
    ready_s: np.ndarray          # instance ready to execute (NaN if lost)
    done_s: np.ndarray           # execution finished (NaN if lost)
    host: np.ndarray             # final host id (-1 if never placed)
    mode: np.ndarray             # MODE_* of the attempt that succeeded
    restarts: np.ndarray         # crash-induced re-placements
    fn: np.ndarray
    counters: Dict[str, int]
    host_peak: int
    inflight_peak: int

    def cold_start(self) -> np.ndarray:
        """ready - arrival per completed invocation (queue wait included)."""
        ok = ~np.isnan(self.ready_s)
        return (self.ready_s - self.arrival_s)[ok]

    def summary(self) -> Dict[str, float]:
        cs = self.cold_start()
        done = ~np.isnan(self.done_s)
        span = float(self.done_s[done].max() - self.arrival_s.min()) \
            if done.any() else 0.0
        out = {
            "invocations": int(self.arrival_s.size),
            "completed": int(done.sum()),
            "throughput_rps": float(done.sum() / span) if span > 0 else 0.0,
            "p50_cold_start_s": float(np.percentile(cs, 50)) if cs.size else 0.0,
            "p99_cold_start_s": float(np.percentile(cs, 99)) if cs.size else 0.0,
            "mean_cold_start_s": float_mean(cs) if cs.size else 0.0,
            "warm_frac": float((self.mode == MODE_WARM).mean()) if cs.size else 0.0,
            "join_frac": float((self.mode == MODE_JOIN).mean()) if cs.size else 0.0,
            "host_peak": int(self.host_peak),
            "inflight_peak": int(self.inflight_peak),
        }
        out.update({k: int(v) for k, v in self.counters.items()})
        return out


class FleetDriver:
    """Single-heap discrete-event loop serving a trace against the hosts."""

    def __init__(self, fleet: List[FunctionType],
                 profiles: Dict[int, RestoreProfile],
                 policy: str = "locality", seed: int = 0,
                 n_hosts: int = 8, slots_per_host: int = 64,
                 clock: Optional[Clock] = None,
                 autoscaler: Optional[QueueAutoscaler] = None,
                 keep_warm: bool = True,
                 crash_at: Optional[List[Tuple[float, int]]] = None):
        self.fleet = {f.fn_id: f for f in fleet}
        self.profiles = profiles
        self.scheduler = PlacementScheduler(policy, seed=seed)
        self.clock = clock or REAL_CLOCK
        self.autoscaler = autoscaler
        self.keep_warm = keep_warm
        self.slots_per_host = slots_per_host
        self.hosts: List[HostState] = [
            HostState(i, slots=slots_per_host) for i in range(n_hosts)]
        self._crash_at = list(crash_at or [])
        self._events: List[Tuple[float, int, int, tuple]] = []
        self._seq = 0
        # fn_id -> host ids holding a warm instance (scan-free warm hits)
        self._warm_hosts: Dict[int, set] = {}
        # fn_id -> (worthwhile, gap): the keep-warm verdict depends only on
        # the fn's uncontended restore cost, rate, and resident bytes
        self._keepwarm: Dict[int, Tuple[bool, float]] = {}
        self._total_queued = 0
        self._n_alive = len(self.hosts)
        self.counters = {
            "cold_restores": 0, "joins": 0, "warm_hits": 0,
            "keepwarm_held": 0, "keepwarm_expired": 0,
            "crashes": 0, "crash_requeued": 0,
            "scale_ups": 0, "scale_downs": 0,
        }

    # -- event plumbing ----------------------------------------------------
    def _push(self, t: float, kind: int, *data) -> None:
        self._seq += 1
        heapq.heappush(self._events, (t, kind, self._seq, data))

    def _alive(self) -> List[HostState]:
        return [h for h in self.hosts if h.alive]

    # -- the run -----------------------------------------------------------
    def run(self, trace: Trace) -> FleetResult:
        n = len(trace)
        self._arr = trace.t
        self._fn = trace.fn
        self._comp = trace.compute_s
        self._ready = np.full(n, np.nan)
        self._done = np.full(n, np.nan)
        self._host = np.full(n, -1, np.int32)
        self._mode = np.full(n, -1, np.int8)
        self._restarts = np.zeros(n, np.int32)
        self._inflight = 0
        self._inflight_peak = 0
        self._host_peak = len(self.hosts)
        for i in range(n):
            self._push(float(trace.t[i]), EV_ARRIVAL, i)
        for t, host_id in self._crash_at:
            self._push(float(t), EV_CRASH, host_id)
        while self._events:
            t, kind, _seq, data = heapq.heappop(self._events)
            if hasattr(self.clock, "advance_to"):
                self.clock.advance_to(t)
            if kind == EV_ARRIVAL:
                self._on_arrival(t, data[0])
            elif kind == EV_RESTORE_DONE:
                self._on_restore_done(t, *data)
            elif kind == EV_COMPUTE_DONE:
                self._on_compute_done(t, *data)
            elif kind == EV_WARM_EXPIRE:
                self._on_warm_expire(t, *data)
            elif kind == EV_CRASH:
                self._on_crash(t, data[0])
        return FleetResult(
            arrival_s=self._arr, ready_s=self._ready, done_s=self._done,
            host=self._host, mode=self._mode, restarts=self._restarts,
            fn=self._fn, counters=dict(self.counters),
            host_peak=self._host_peak, inflight_peak=self._inflight_peak)

    # -- handlers ----------------------------------------------------------
    def _on_arrival(self, t: float, i: int) -> None:
        self._inflight += 1
        self._inflight_peak = max(self._inflight_peak, self._inflight)
        self._autoscale(t)
        fn = self.fleet[int(self._fn[i])]
        # 1) warm hit: lowest host id with a warm instance AND a free slot
        if self.keep_warm:
            for hid in sorted(self._warm_hosts.get(fn.fn_id, ())):
                h = self.hosts[hid]
                if not h.alive or h.free_slots() <= 0:
                    continue
                dq = h.warm[fn.fn_id]
                dq.popleft()            # consume the oldest warm instance
                if not dq:
                    del h.warm[fn.fn_id]
                    self._warm_unindex(fn.fn_id, hid)
                self.counters["warm_hits"] += 1
                h.busy += 1
                ready = t + WARM_RESUME_S
                self._ready[i] = ready
                self._host[i] = h.host_id
                self._mode[i] = MODE_WARM
                self._push(ready + float(self._comp[i]), EV_COMPUTE_DONE,
                           h.host_id, i)
                return
        self._place(t, i)

    def _warm_unindex(self, fn_id: int, host_id: int) -> None:
        s = self._warm_hosts.get(fn_id)
        if s is not None:
            s.discard(host_id)
            if not s:
                del self._warm_hosts[fn_id]

    def _place(self, t: float, i: int) -> None:
        fn = self.fleet[int(self._fn[i])]
        h = self.scheduler.choose(self.hosts, fn, self.profiles[fn.fn_id])
        if h is None:       # no alive hosts: autoscaler will revive the pod
            self._grow(max(1, self.autoscaler.min_hosts
                           if self.autoscaler else 1))
            h = self.scheduler.choose(self.hosts, fn, self.profiles[fn.fn_id])
        if h.free_slots() > 0:
            self._start_restore(t, h, i)
        else:
            h.queue.append(i)
            self._total_queued += 1

    def _start_restore(self, t: float, h: HostState, i: int) -> None:
        fn = self.fleet[int(self._fn[i])]
        profile = self.profiles[fn.fn_id]
        h.busy += 1
        self._host[i] = h.host_id
        group_finish = h.active_restores.get(fn.name)
        if group_finish is not None:
            # join the in-flight fan-out group: shared reads already in
            # motion, this member pays only its CPU-side installs
            finish = max(group_finish,
                         t + self.scheduler.priced(fn, profile, 1, 0.0,
                                                   joined=True))
            self.counters["joins"] += 1
            self._mode[i] = MODE_JOIN
        else:
            conc = len(h.active_restores) + 1
            finish = (t + self.scheduler.priced(fn, profile, conc,
                                                h.overlap_frac(fn, profile))
                      + self.scheduler.topology_penalty(h, fn, profile, conc))
            if self.scheduler.topology is not None:
                self.scheduler.topology.note_placement(h.host_id, fn.fn_id)
            h.active_restores[fn.name] = finish
            self.counters["cold_restores"] += 1
            self._mode[i] = MODE_COLD
        self._push(finish, EV_RESTORE_DONE, h.host_id, i, fn.name)

    def _on_restore_done(self, t: float, host_id: int, i: int,
                         name: str) -> None:
        h = self.hosts[host_id]
        if not h.alive:
            return              # crash handler already re-placed this one
        # once the group's shared reads are complete there is nothing left
        # to join: late joiners only run their installs past this point
        gf = h.active_restores.get(name)
        if gf is not None and t >= gf:
            h.active_restores.pop(name, None)
        fn = self.fleet[int(self._fn[i])]
        h.add_resident(fn.base_group)
        self._ready[i] = t
        self._push(t + float(self._comp[i]), EV_COMPUTE_DONE, host_id, i)

    def _on_compute_done(self, t: float, host_id: int, i: int) -> None:
        h = self.hosts[host_id]
        if not h.alive:
            return
        self._done[i] = t
        self._inflight -= 1
        h.busy -= 1
        fn = self.fleet[int(self._fn[i])]
        profile = self.profiles[fn.fn_id]
        # the completing instance holds exactly one residency count: cold
        # and join restores added it at restore-done, a warm resume
        # inherited it from the held instance it consumed
        held = False
        if self.keep_warm:
            cached = self._keepwarm.get(fn.fn_id)
            if cached is None:
                gap = 1.0 / max(fn.rate_rps, 1e-9)
                econ = keepwarm_economics(
                    restore_s=profile.cold_start_s(1),
                    expected_gap_s=gap,
                    resident_bytes=profile.hot_bytes + profile.cold_bytes)
                cached = (bool(econ["worthwhile"]), gap)
                self._keepwarm[fn.fn_id] = cached
            worthwhile, gap = cached
            if worthwhile:
                h.warm.setdefault(fn.fn_id, deque()).append(t + gap)
                self._warm_hosts.setdefault(fn.fn_id, set()).add(host_id)
                self.counters["keepwarm_held"] += 1
                self._push(t + gap, EV_WARM_EXPIRE, host_id, fn.fn_id)
                held = True
        if not held:
            h.drop_resident(fn.base_group)
        self._drain_queue(t, h)

    def _on_warm_expire(self, t: float, host_id: int, fn_id: int) -> None:
        h = self.hosts[host_id]
        if not h.alive:
            return
        dq = h.warm.get(fn_id)
        # the warm hit path pops from the left, so expiries and hits stay
        # matched FIFO; an empty deque means every held instance was used
        if dq and dq[0] <= t:
            dq.popleft()
            if not dq:
                del h.warm[fn_id]
                self._warm_unindex(fn_id, host_id)
            self.counters["keepwarm_expired"] += 1
            h.drop_resident(self.fleet[fn_id].base_group)

    def _on_crash(self, t: float, host_id: int) -> None:
        if host_id >= len(self.hosts) or not self.hosts[host_id].alive:
            return
        h = self.hosts[host_id]
        h.alive = False
        self._n_alive -= 1
        self.counters["crashes"] += 1
        for fn_id in h.warm:
            self._warm_unindex(fn_id, host_id)
        # every invocation bound to this host that has not completed is
        # re-placed on the survivors and restored from scratch
        victims = [i for i in range(self._arr.size)
                   if self._host[i] == host_id and np.isnan(self._done[i])]
        victims.extend(h.queue)
        self._total_queued -= len(h.queue)
        h.queue.clear()
        h.active_restores.clear()
        h.warm.clear()
        h.resident_groups.clear()
        h.busy = 0
        for i in sorted(set(victims)):
            self._host[i] = -1
            self._mode[i] = -1
            self._ready[i] = np.nan
            self._restarts[i] += 1
            self.counters["crash_requeued"] += 1
            self._place(t, i)

    # -- pod sizing --------------------------------------------------------
    def _autoscale(self, t: float) -> None:
        if self.autoscaler is None:
            return
        delta = self.autoscaler.decide(t, self._total_queued, self._n_alive)
        if delta > 0:
            self._grow(delta)
            self.counters["scale_ups"] += 1
        elif delta < 0:
            removed = 0
            for h in reversed(self.hosts):
                if removed >= -delta:
                    break
                if h.alive and h.busy == 0 and not h.queue and not h.warm:
                    h.alive = False
                    self._n_alive -= 1
                    removed += 1
            if removed:
                self.counters["scale_downs"] += 1

    def _grow(self, k: int) -> None:
        for _ in range(k):
            self.hosts.append(HostState(len(self.hosts),
                                        slots=self.slots_per_host))
        self._n_alive += k
        self._host_peak = max(self._host_peak, self._n_alive)

    def _drain_queue(self, t: float, h: HostState) -> None:
        while h.queue and h.free_slots() > 0:
            self._total_queued -= 1
            self._start_restore(t, h, h.queue.popleft())
