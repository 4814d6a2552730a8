"""Share of the traced stretch of whole samples in which no operation ran
on the device (the union of its kernels, copies and sets)."""


def read(m):
    t = m.get("trace")
    if not t or not t["device_ops"]:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
