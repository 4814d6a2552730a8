"""Spans the benchmark records around its calls into the program, and the
reduction of a ``torch.profiler`` Chrome trace to the traced stretch's
numbers.

Device operations are the trace's kernel, memcpy and memset events (not
the annotations the profiler mirrors onto the device timeline). The
stretch is the host span ``STRETCH``; its device busy time is the union of
the device operations inside it (overlaps counted once), its idle share
the rest. Each idle gap is named by the innermost host span open at its
middle: a stage of the runner's host loop (``stage.<name>``, recorded by
``AnnotatedTimer``) or one of the benchmark's own spans.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json

import torch

from vargeno_tpu_torch.utils.profiling import StageTimer

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "genobench.stretch"
VOTE_KERNEL = "vote_kernel"
TOP = 10


def span(name: str):
    """A host span in a trace (``record_function``); a no-op cost otherwise
    of a few microseconds."""
    return torch.profiler.record_function(name)


class AnnotatedTimer(StageTimer):
    """The runner's stage timer, each stage also a span ``stage.<name>``."""

    def __init__(self):
        super().__init__(sync=False)

    @contextlib.contextmanager
    def stage(self, name, block_on=None):
        with span("stage." + name), super().stage(name, block_on):
            yield


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def union(intervals) -> list:
    """Merged (start, end) intervals, ascending."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list) -> dict:
    """The stretch's numbers (seconds): window, device busy, device
    operations and their time by name, the vote kernel's time and
    launches, and the longest idle gaps with the host span they fell in."""
    xs = [e for e in events if e.get("ph") == "X"]
    stretch = [e for e in xs if e.get("name") == STRETCH
               and e.get("cat") != "gpu_user_annotation"]
    if not stretch:
        raise ValueError(f"the trace holds no {STRETCH} span")
    lo = float(stretch[0]["ts"])
    hi = lo + float(stretch[0]["dur"])
    dev, spans = [], []
    for e in xs:
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if e.get("cat") in DEVICE_CATS:
            if lo <= ts < hi:
                dev.append((ts, min(ts + dur, hi), e.get("name", "?"), dur))
        elif e.get("cat") == "user_annotation" and e["name"] != STRETCH:
            spans.append((ts, ts + dur, e["name"]))
    busy = union((s, e) for s, e, _, _ in dev)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for _, _, name, dur in dev:
        by_name[name][0] += dur
        by_name[name][1] += 1
    vote = [(d, n) for name, (d, n) in by_name.items() if VOTE_KERNEL in name]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    spans.sort()
    starts = [s for s, _, _ in spans]

    def host_at(t):
        j = bisect.bisect_right(starts, t)
        inner = [(e - s, name) for s, e, name in spans[:j] if e > t]
        return min(inner)[1] if inner else "outside"

    return dict(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        device_ops=len(dev),
        device_by_name=[[name, d / 1e6, n] for name, (d, n) in sorted(
            by_name.items(), key=lambda kv: -kv[1][0])],
        vote_kernel_s=sum(d for d, _ in vote) / 1e6,
        vote_kernel_launches=sum(n for _, n in vote),
        idle_gaps=[[host_at((s + e) / 2), (e - s) / 1e6]
                   for s, e in gaps[:TOP]])
