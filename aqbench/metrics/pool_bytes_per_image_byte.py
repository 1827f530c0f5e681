"""Bytes the CXL and RDMA tiers hold for the live snapshots over their
image bytes, once the window's work has drained and every retired version
is collected (``MemoryTier.bytes_in_use`` of both tiers)."""


def read(rec):
    return (rec["pool"]["cxl_bytes"] + rec["pool"]["rdma_bytes"]) / rec["pool"]["image_bytes"]
