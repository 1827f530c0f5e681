"""Median milliseconds from a cold start's request to its session attached
(borrow, CXL invalidation, machine state, node-server attach): the harness's
span around ``Orchestrator.restore`` without pre-install."""
from aqbench.trace import percentile


def read(rec):
    v = percentile(rec["seconds"].get("attach", []), 50)
    return None if v is None else v * 1e3
