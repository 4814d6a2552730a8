"""Seconds from the process's start to the first timed sample: imports,
input synthesis, the in-memory index build, the placement on the device
and the warm-up."""


def read(m):
    return m["setup_s"]
