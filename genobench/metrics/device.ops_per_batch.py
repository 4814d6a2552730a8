"""Device operations in the traced stretch per batch dispatched in it
(forward, retry and redone batches)."""


def read(m):
    t = m.get("trace")
    if not t or not t["device_ops"] or not t["batches"]:
        return None
    return t["device_ops"] / t["batches"]
