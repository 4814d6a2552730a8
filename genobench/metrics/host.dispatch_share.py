"""Share of the window the runner's main thread spent in its ``dispatch``
stage (``GenoRunner.timer``): issuing forward batches' steps."""


def read(m):
    return m["stages"].get("dispatch", 0.0) / m["window_s"]
