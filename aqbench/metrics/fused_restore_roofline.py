"""Percent of the HBM roof the fused restore kernel reaches: the bytes of
every page installed through it (4 KiB read, 4 KiB written, its 4-byte
checksum read) at 3.35 TB/s, over the kernel's device time summed from the
trace (verify-only launches included)."""
from aqbench import roofline


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    t = sum(s for n, s in tr["by_name"].items() if roofline.matches("fused_restore", n))
    return roofline.share(roofline.restore_bytes(rec["work"]["restore_pages"]), t)
