"""Cold starts done inside the window over the window's seconds (host
clock).  A start is done when its release returns after a device
synchronize; a start still running when the window closes counts with the
share of its time that lies inside the window, so the rate holds all the
work and all the time of the window."""


def read(rec):
    return rec["done"] / rec["window_s"]
