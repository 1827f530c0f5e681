"""Inter-pod data-plane routing: priced reads of a remote pod's tiers.

A host whose home pod holds no replica (or whose MHD ports are exhausted)
reaches a remote pod over the RDMA fabric plus one switch hop.  The price
goes through the same machinery as intra-pod reads: a per-(host, remote
pod) :class:`~repro_torch.core.pool.LinkArbiter` over an inter-pod
:class:`~repro_torch.core.pool.CostModel` built from the
``strategies.INTER_POD_*`` constants, so the executed path and the
analytic model (``strategies.interpod_bulk_read_s``) share one set of
numbers.

Partitions are data-plane only: a downed link refuses bulk reads
(:class:`PodLinkDown`) while the control plane — catalog atomics, lease
words — keeps working, matching a fabric cut that spares the management
network.  Modeled seconds are the paper's cost model, not device times.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from ..core.pool import CostModel, LinkArbiter
from ..serve.strategies import (
    INTER_POD_BW,
    INTER_POD_INFLIGHT,
    INTER_POD_LAT_S,
)

#: The inter-pod fabric: RNIC path plus one switch hop (DESIGN.md §16).
INTER_POD_COST = CostModel(op_latency_s=INTER_POD_LAT_S,
                           bandwidth_Bps=INTER_POD_BW,
                           max_inflight=INTER_POD_INFLIGHT)


class PodLinkDown(RuntimeError):
    """The data-plane link between two pods is partitioned."""


class InterPodRouter:
    """Routes and prices one host's bulk reads of remote pods' tiers."""

    def __init__(self, group):
        self.group = group
        self._lock = threading.Lock()
        self._arbiters: Dict[Tuple[str, int], LinkArbiter] = {}
        self.stats = {"interpod_reads": 0, "interpod_bytes": 0,
                      "partition_refusals": 0}

    def arbiter_for(self, host: str, dst_pod: int) -> LinkArbiter:
        """The contention arbiter for `host`'s fabric path to `dst_pod`
        (distinct remote pods ride distinct switch paths; streams from one
        host to one pod share)."""
        with self._lock:
            key = (host, dst_pod)
            arb = self._arbiters.get(key)
            if arb is None:
                arb = self._arbiters[key] = LinkArbiter(INTER_POD_COST)
            return arb

    def check_reachable(self, host: str, dst_pod: int) -> None:
        """Raise :class:`PodLinkDown` when the data-plane path from
        `host`'s home pod to `dst_pod` is partitioned or the pod is dead."""
        home = self.group.home_pod(host)
        if not self.group.link_up(home, dst_pod):
            with self._lock:
                self.stats["partition_refusals"] += 1
            raise PodLinkDown(
                f"pod link {home} -> {dst_pod} is down (host {host!r})")

    def charge_read(self, host: str, dst_pod: int, nbytes: int,
                    ops: int = 1) -> float:
        """Modeled seconds for `host` reading `nbytes` from `dst_pod` over
        the inter-pod fabric (pipelined one-sided reads, fair-shared with
        the host's other active inter-pod streams)."""
        self.check_reachable(host, dst_pod)
        t = self.arbiter_for(host, dst_pod).charge_pipelined(nbytes, ops)
        with self._lock:
            self.stats["interpod_reads"] += 1
            self.stats["interpod_bytes"] += int(nbytes)
        return t

    def read(self, host: str, dst_pod: int, tier_tag: int, offset: int,
             nbytes: int) -> Tuple[torch.Tensor, float]:
        """The remote tier's bytes (a tensor on that pod's device) + the
        modeled charge."""
        self.check_reachable(host, dst_pod)
        data = self.group.pod(dst_pod).pool.tier(tier_tag).read(offset, nbytes)
        return data, self.charge_read(host, dst_pod, nbytes)
