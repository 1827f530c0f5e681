"""Percent of the traced window in which no kernel, copy or memset ran on
the card (the union of the profiler's device intervals)."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
