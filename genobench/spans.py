"""Device time by program span in a ``torch.profiler`` Chrome trace, and one
traced sample of a cell that keeps its trace and reports it by span.

    python3 -m genobench.spans --workload <cell> --seed <n> [--out DIR]

``device_by_span`` attributes each device operation of the stretch (a
kernel, copy or set: ``trace.DEVICE_CATS``) to the innermost program span
(``step.*`` or ``stage.*``) open on the launching thread at its launch:
the ``cuda_runtime`` / ``cuda_driver`` event with the same ``correlation``
arg. A span's seconds are the union of its operations' intervals;
operations with no such span, or no launch event, go to ``other``.

The command runs the cell as ``genobench.run`` does up to the warm-up,
times two untraced samples, then one sample under ``torch.profiler`` with
every thread recorded where this torch can (the producer thread's
``stage.producer.*`` spans, which the benchmark's traced stretch does not
record), and prints one JSON line: the untraced and traced seconds, the
stretch's ``trace.summarize`` keys, ``device_by_span`` with each span's
milliseconds a batch, the count of each span, the runner's counters and
the vote's launches over the traced sample, and the hash table's probe
chain where the runner has one. ``--out DIR`` keeps the trace there.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import trace  # noqa: E402

PROGRAM = ("step.", "stage.")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OTHER = "other"
UNTRACED = 2   # untraced samples timed before the traced one


def _innermost(spans: list, points: list) -> list:
    """For each time in ``points`` (ascending), the name of the innermost
    of ``spans`` ((start, end, name), properly nested, one thread's) open
    there, or None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack, out, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _stretch(xs: list) -> tuple:
    s = [e for e in xs if e.get("name") == trace.STRETCH
         and e.get("cat") != "gpu_user_annotation"]
    if not s:
        raise ValueError(f"the trace holds no {trace.STRETCH} span")
    lo = float(s[0]["ts"])
    return lo, lo + float(s[0]["dur"])


def device_by_span(events: list) -> list:
    """[[span, seconds, operations]] of the stretch's device operations by
    the innermost program span at their launch, most seconds first."""
    xs = [e for e in events if e.get("ph") == "X"]
    lo, hi = _stretch(xs)
    launch, spans = {}, collections.defaultdict(list)
    dev = []
    for e in xs:
        cat = e.get("cat")
        if cat in trace.DEVICE_CATS:
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            if lo <= ts < hi:
                dev.append((ts, min(ts + dur, hi),
                            (e.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = (e.get("tid"), float(e["ts"]))
        elif cat == "user_annotation" and e["name"].startswith(PROGRAM):
            ts = float(e["ts"])
            spans[e.get("tid")].append((ts, ts + float(e.get("dur", 0)),
                                        e["name"]))
    at = collections.defaultdict(list)   # tid -> [(launch ts, op index)]
    owner = [OTHER] * len(dev)
    for i, (_, _, c) in enumerate(dev):
        if c in launch:
            tid, ts = launch[c]
            at[tid].append((ts, i))
    for tid, pts in at.items():
        pts.sort()
        names = _innermost(spans.get(tid, []), [t for t, _ in pts])
        for (_, i), name in zip(pts, names):
            owner[i] = name or OTHER
    by = collections.defaultdict(list)
    for (s, e, _), name in zip(dev, owner):
        by[name].append((s, e))
    out = [[name, sum(e - s for s, e in trace.union(iv)) / 1e6, len(iv)]
           for name, iv in by.items()]
    return sorted(out, key=lambda r: -r[1])


def span_counts(events: list) -> dict:
    """Each program span's count in the stretch, by name."""
    xs = [e for e in events if e.get("ph") == "X"]
    lo, hi = _stretch(xs)
    n = collections.Counter(
        e["name"] for e in xs if e.get("cat") == "user_annotation"
        and e["name"].startswith(PROGRAM) and lo <= float(e["ts"]) < hi)
    return dict(sorted(n.items()))


def traced_sample(cell, seed: int, work: str,
                  keep: str | None = None) -> dict:
    """One cell's sample traced on the card, as the module's docstring
    says. Goes with ``device_by_span``'s move into ``trace.summarize``,
    which makes the benchmark's own traced stretch report it."""
    from torch.profiler import ProfilerActivity, profile

    from vargeno_tpu_torch.utils.profiling import StageTimer, _all_threads

    from . import harness

    vote = harness.VoteCounter()
    p = harness.place(cell, seed, work, "cuda", T_START, vote)
    runner, inputs = p.runner, p.inputs
    harness.warm(runner, inputs, work)
    runner.timer = StageTimer(sync=False)
    plain = [harness.sample(runner, inputs, os.path.join(work, "u.vcf"))
             for _ in range(UNTRACED)]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    runner.timer = StageTimer(sync=False)
    before = harness.counters(runner)
    launches0 = vote.launches
    harness.sync(runner.device)
    with profile(activities=acts, experimental_config=_all_threads()) as pr:
        with trace.span(trace.STRETCH):
            traced = harness.sample(runner, inputs,
                                    os.path.join(work, "t.vcf"))
            harness.sync(runner.device)
    c = harness.delta(harness.counters(runner), before)
    path = os.path.join(keep or work, "trace.json")
    if keep:
        os.makedirs(keep, exist_ok=True)
    pr.export_chrome_trace(path)
    del pr
    events = trace.load(path)
    if not keep:
        os.remove(path)
    res = trace.summarize(events)
    loop = int(cell.mix["batch_reads"]) * int(cell.config["runner"].get(
        "mesh") or 1)
    batches = (-(-inputs.n_reads // loop) + c["retry_batches"]
               + c["escalations"] + c["rewinds"])
    by_span = device_by_span(events)
    res.update(
        device_by_span=by_span,
        ms_per_batch={n: 1e3 * s / batches for n, s, _ in by_span},
        span_counts=span_counts(events), batches=batches, counters=c,
        vote_launches=vote.launches - launches0,
        untraced_s=[s.seconds for s in plain], traced_s=traced.seconds,
        stages=traced.stages,
        both_ht_chain=getattr(runner.dix, "both_ht_chain", None))
    return res


def main(argv=None) -> int:
    from . import spec

    ap = argparse.ArgumentParser(prog="python3 -m genobench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None, help="keep the trace here")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    work = tempfile.mkdtemp(prefix="genobench-spans-")
    try:
        res = traced_sample(cell, args.seed, work, args.out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["device_by_name"] = res["device_by_name"][:trace.TOP]
    print(json.dumps({"workload": args.workload, "seed": args.seed, **res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
