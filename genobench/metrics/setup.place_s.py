"""Seconds from the runner's construction over the built index to a
device synchronise: the device tables derived and placed."""


def read(m):
    return m["setup"].get("place_s")
