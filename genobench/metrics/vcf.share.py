"""Share of the window spent in ``write_vcf`` (the calls and the VCF
rewrite), timed by the benchmark around the call."""


def read(m):
    return m["vcf_s"] / m["window_s"]
