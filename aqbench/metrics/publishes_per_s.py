"""Versions published, and their predecessors deleted and collected,
inside the window over the window's seconds (host clock); a deploy still
running when the window closes counts with the share of its time inside
it."""


def read(rec):
    return rec["done"] / rec["window_s"]
