"""Share of the window the runner's main thread waited in ``read_batch``
(``GenoRunner.timer``) for the producer thread's parsed, encoded and
uploaded batch."""


def read(m):
    return m["stages"].get("read_batch", 0.0) / m["window_s"]
