"""Seconds of the in-memory index build: the sum of ``build_index``'s own
stage timings."""


def read(m):
    return m["setup"].get("index_build_s")
