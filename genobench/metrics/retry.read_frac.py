"""Reads re-run reverse-complemented after a failed forward pass, over the
reads genotyped in the window (the runner's ``n_retry_reads`` and
``n_reads``)."""


def read(m):
    c = m["counts"]
    return c["retry_reads"] / c["reads"] if c["reads"] else None
