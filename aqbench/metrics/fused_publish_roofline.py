"""Percent of the HBM roof the fused publish sweep reaches: each publish's
image read once and its compacted pages, zero bitmap and checksums written
once, at 3.35 TB/s, over the kernel's device time summed from the trace."""
from aqbench import roofline


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    t = sum(s for n, s in tr["by_name"].items() if roofline.matches("fused_publish", n))
    return roofline.share(sum(roofline.publish_bytes(n, nnz) for n, nnz in rec["work"]["publish"]),
                          t)
