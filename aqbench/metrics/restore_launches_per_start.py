"""Kernel launches of the restore wrappers (``fused_restore.launches`` +
``page_scatter.launches``) per cold start completed in the window and its
drain."""


def read(rec):
    n = rec["counters"]["ops"]
    if not n:
        return None
    return rec["counters"]["restore_launches"] / n
