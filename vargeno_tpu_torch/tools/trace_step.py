"""A ``torch.profiler`` trace of one steady pass of the bench workload (port
of ``tools/trace_step.py``), summarized by ``tools/summarize_trace.py``.

    python -m vargeno_tpu_torch.tools.trace_step [--device cuda|cpu]
        [--out DIR]

Loads the bench workload's index (``tools/bench.py``: its dataset and index,
found through the same ``VGT_BENCH_*`` knobs), runs one untimed pass of the
bench's queued configuration to warm it, then records host and device
activity over a second whole pass (``consume_fastq`` ending in a
synchronise) and writes the Chrome trace to ``DIR/trace.json`` (default:
``trace/`` in the bench's cache directory; it opens in Perfetto). Prints the
pass's seconds, the summary (device time by kernel name, device operations,
the device's idle share of the window) and one JSON line
``{"trace_step": ...}``. On the card a trace that holds no device operation
fails the tool: the profiler kept no device activity, and no zeros are
printed in its place. On the host (``--device cpu``) there is no device
timeline: the trace is written and only its host events are counted.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import bench, summarize_trace


def trace(wl: bench.Workload, device, out_dir: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ..engine.device_index import build_device_index

    device = torch.device(device)
    on_cuda = device.type == "cuda"
    index = bench.load_index(wl)
    with bench.stage("index load + device tables"):
        dix = build_device_index(index, device,
                                 bench.bench_config(wl).ht_target_load)
        bench.sync(device)
    runner = bench.make_runner(index, dix, wl, "queued", device)
    with bench.stage("warm pass"):
        runner.consume_fastq(wl.fq)
        bench.sync(device)
    runner.ref_cnt, runner.alt_cnt = runner._fresh_counts()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda
                                     else [])
    n0 = runner.n_reads
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.consume_fastq(wl.fq)
        bench.sync(device)
        pass_s = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    with bench.stage("export the Chrome trace"):
        prof.export_chrome_trace(path)
    s = summarize_trace.summarize(summarize_trace.load(path))
    if on_cuda and not s["device_ops"]:
        raise RuntimeError(f"torch.profiler kept no device activity in "
                           f"{path} ({s['host_ops']} host events): no "
                           f"device time or idle share to report")
    return dict(device=bench.device_label(device),
                trace=path, reads=runner.n_reads - n0,
                pass_s=round(pass_s, 4), **s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.trace_step",
        description="torch.profiler trace of one steady bench pass")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--out", default=None,
                    help="directory of trace.json (default: trace/ in the "
                         "bench's cache directory)")
    args = ap.parse_args(argv)
    if bench.no_card(args.device):
        return 1
    wl = bench.Workload.from_env()
    res = trace(wl, args.device, args.out or wl.path("trace"))
    print(f"traced pass: {res['reads']} reads in {res['pass_s']} s "
          f"(profiler on) on {res['device']}")
    if res["device_ops"]:
        print(summarize_trace.report(res))
    else:
        print(f"host run: {res['host_ops']} host events, no device timeline")
    print(json.dumps({"trace_step": dict(
        res, device_by_name=res["device_by_name"][:40],
        host_by_name=res["host_by_name"][:40])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
