"""Sweep the host dispatch pipeline's knobs -- group_size x pipeline_depth x
pre_encode -- on the bench workload and print reads/s for each point, then
the main thread's stage split of the best one (port of
``tools/tune_host_pipeline.py``).

    python -m vargeno_tpu_torch.tools.tune_host_pipeline [quick]
        [--device cuda|cpu] [--passes N]

It reads the bench's dataset and index (``VGT_BENCH_CACHE`` and the other
``VGT_BENCH_*`` knobs of ``tools/bench.py``, which makes them). Every point
is the queued GenoRunner at the bench's configuration with the point's
knobs: a warm run of 2 x G batches, then ``--passes`` full passes from fresh
counts, its best pass kept. The codes path (``pre_encode`` off) runs at
(1, 1); the pre-encoded points are (1, 2) and (8, 2) with ``quick``, else
every (G, depth) of (1, 4, 8) x (1, 2, 4). The best point then runs one
more pass, and the seconds its main thread spent in each stage of the host
loop (``GenoRunner.timer``: read_batch, dispatch, finalize_wait,
enqueue_retry) are printed. Every point must give the counts of the first.
The last line of stdout is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys
import time

import numpy as np
import torch

from . import bench


def run_point(index, dix, wl, device, group: int, depth: int,
              pre_encode: bool = True, passes: int = 2):
    """(best reads/s, every pass's, the runner) of one point."""
    from ..engine.geno import GenoRunner
    from ..utils.profiling import StageTimer

    cfg = dataclasses.replace(bench.bench_config(wl), group_size=group,
                              pipeline_depth=depth, pre_encode=pre_encode)
    runner = GenoRunner(index, cfg, device=device, dix=dix)
    runner.consume_fastq(wl.fq, limit_batches=2 * max(group, 1))   # warm
    runner.timer = StageTimer(sync=False)   # the timed passes' stages
    rates = [bench.timed_pass(runner, wl.fq) for _ in range(passes)]
    print(f"group={group} depth={depth} pre={pre_encode}: "
          f"{max(rates):,.0f} reads/s (passes: "
          + ", ".join(f"{r:,.0f}" for r in rates) + ")", flush=True)
    return max(rates), rates, runner


def sweep_points(quick: bool) -> list:
    """(group, depth, pre_encode) points, the codes path first."""
    pairs = ([(1, 2), (8, 2)] if quick
             else list(itertools.product((1, 4, 8), (1, 2, 4))))
    return [(1, 1, False)] + [(g, d, True) for g, d in pairs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.tune_host_pipeline",
        description="reads/s over the host pipeline's knobs")
    ap.add_argument("quick", nargs="?", choices=["quick"],
                    help="only the (1, 2) and (8, 2) group / depth points")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--passes", type=int, default=2,
                    help="timed full passes a point (the best is kept)")
    args = ap.parse_args(argv)
    if bench.no_card(args.device):
        return 1
    from ..engine.device_index import build_device_index
    from ..index import store

    device = torch.device(args.device)
    wl = bench.Workload.from_env()
    index = store.load(wl.prefix)
    dix = build_device_index(index, device, bench.bench_config(wl)
                             .ht_target_load)
    results, want = [], None
    for g, d, pre in sweep_points(args.quick is not None):
        rate, rates, runner = run_point(index, dix, wl, device, g, d, pre,
                                        args.passes)
        got = runner.host_counts()
        if want is None:
            want = got
        elif not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"group={g} depth={d} pre={pre}: counts "
                                 f"differ from the first point's")
        results.append(dict(group_size=g, pipeline_depth=d, pre_encode=pre,
                            reads_per_s=round(rate, 1),
                            passes=[round(r, 1) for r in rates]))
    best = max(results, key=lambda r: r["reads_per_s"])
    print(f"\nBEST group={best['group_size']} depth="
          f"{best['pipeline_depth']} pre={best['pre_encode']}: "
          f"{best['reads_per_s']:,.0f} reads/s", flush=True)
    _, _, runner = run_point(index, dix, wl, device, best["group_size"],
                             best["pipeline_depth"], best["pre_encode"], 1)
    print("\nmain-thread stages of the best point (one pass):")
    print(runner.timer.report(), flush=True)
    print(json.dumps(dict(
        points=results, best=best, device=bench.device_label(device),
        stages={k: round(v, 4) for k, v in runner.timer.totals.items()},
        t=round(time.perf_counter() - bench.T0, 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
