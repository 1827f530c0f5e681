"""Seconds from the process's start to the window's: imports, the kernels'
build or load, the images, the publishes, the warm-up operation."""


def read(rec):
    return rec["setup_s"]
