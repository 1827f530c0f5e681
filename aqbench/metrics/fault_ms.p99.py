"""99th percentile of milliseconds a guest touch of an absent page waits
(``RestoreEngine.access`` from the fault to the page installed by the node
server's completion worker); needs 1,000 faults or more."""
from aqbench.trace import percentile


def read(rec):
    xs = rec["seconds"].get("fault", [])
    if len(xs) < 1000:
        return None
    return percentile(xs, 99) * 1e3
