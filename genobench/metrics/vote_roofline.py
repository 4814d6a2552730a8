"""The vote kernel's share of its roofline over the traced stretch, in %:
the launches' summed bound (``genobench.roofline``) over their summed
traced time. Nothing when the stretch traced no vote kernel, or when the
counted launches do not match the traced ones."""

from genobench import roofline


def read(m):
    t = m.get("trace")
    if not t or not t["vote_kernel_launches"] or not t["vote_events"]:
        return None
    if len(t["vote_events"]) != t["vote_kernel_launches"]:
        return None
    peak = roofline.PEAKS.get(m["device_name"], roofline.DEFAULT_PEAK)
    return 100.0 * roofline.vote_bound_s(t["vote_events"], peak) \
        / t["vote_kernel_s"]
