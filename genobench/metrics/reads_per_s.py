"""All reads of all samples in the window over the window's seconds, from
the first sample's start to the last sample's VCF closed."""


def read(m):
    return m["reads"] / m["window_s"]
