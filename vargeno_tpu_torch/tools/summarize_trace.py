"""Summarize a ``torch.profiler`` Chrome trace (port of
``tools/summarize_trace.py``): device time by kernel name, the number of
device operations, and the device's idle share of the traced window.

    python -m vargeno_tpu_torch.tools.summarize_trace TRACE.json[.gz]
        [--top 40]

Device operations are the trace's kernel, memcpy and memset events (not the
annotations the profiler mirrors onto the device's timeline). The window
runs from the first event of the trace to the end of its last, host or
device; the idle share is the part of it in which no device operation ran
(overlapping operations counted once). A trace with no device operation
(the profiler kept no device activity, or the run was on the host) has no
device time to report: ``main`` then says so and exits 1.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(events: list) -> dict:
    """Device and host totals of the complete ("X") events of a trace."""
    dev = collections.defaultdict(lambda: [0.0, 0])
    host = collections.defaultdict(lambda: [0.0, 0])
    spans, lo, hi = [], None, None
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        lo = ts if lo is None else min(lo, ts)
        hi = ts + dur if hi is None else max(hi, ts + dur)
        acc = dev if e.get("cat") in DEVICE_CATS else host
        acc[e.get("name", "?")][0] += dur
        acc[e.get("name", "?")][1] += 1
        if acc is dev:
            spans.append((ts, ts + dur))
    window = (hi - lo) if lo is not None else 0.0
    busy = busy_us(spans)

    def ranked(acc):
        return [(name, round(us, 3), n) for name, (us, n)
                in sorted(acc.items(), key=lambda kv: -kv[1][0])]

    return dict(device_ops=len(spans), device_busy_us=round(busy, 3),
                window_us=round(window, 3),
                idle_share=(round(1.0 - busy / window, 4)
                            if spans and window > 0 else None),
                device_by_name=ranked(dev),
                host_ops=sum(n for _, n in host.values()),
                host_by_name=ranked(host))


def report(s: dict, top: int = 40) -> str:
    lines = [f"window {s['window_us'] / 1e3:.3f} ms, {s['device_ops']} "
             f"device operations, device busy {s['device_busy_us'] / 1e3:.3f}"
             f" ms, idle share {s['idle_share']}; {s['host_ops']} host "
             f"events",
             f"{'device operation':60s} {'total ms':>10s} {'count':>7s}"]
    for name, us, n in s["device_by_name"][:top]:
        lines.append(f"{name[:60]:60s} {us / 1e3:10.3f} {n:7d}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.summarize_trace",
        description="device time by kernel and the idle share of a trace")
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)
    s = summarize(load(args.trace))
    if not s["device_ops"]:
        print(f"error: {args.trace} holds no device operation "
              f"({s['host_ops']} host events): no device time to report",
              file=sys.stderr)
        return 1
    print(report(s, args.top))
    print(json.dumps({"summarize_trace": dict(
        s, device_by_name=s["device_by_name"][:args.top],
        host_by_name=s["host_by_name"][:args.top])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
