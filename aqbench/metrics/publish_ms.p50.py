"""Median milliseconds of one ``PoolMaster.publish`` of a new version (the
harness's span, ending in a device synchronize)."""
from aqbench.trace import percentile


def read(rec):
    v = percentile(rec["seconds"].get("publish", []), 50)
    return None if v is None else v * 1e3
