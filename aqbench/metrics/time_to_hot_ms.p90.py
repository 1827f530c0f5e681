"""90th percentile of milliseconds from a cold start's request until
``RestoreEngine.pre_install_hot`` returns: when the guest may resume."""
from aqbench.trace import percentile


def read(rec):
    v = percentile(rec["seconds"].get("time_to_hot", []), 90)
    return None if v is None else v * 1e3
