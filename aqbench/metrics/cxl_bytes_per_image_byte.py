"""Bytes the CXL tier holds for the live snapshots over their image bytes,
once the window's work has drained (``MemoryTier.bytes_in_use``)."""


def read(rec):
    return rec["pool"]["cxl_bytes"] / rec["pool"]["image_bytes"]
