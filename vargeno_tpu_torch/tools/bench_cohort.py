"""Cohort throughput on one card (port of ``tools/bench_cohort.py``).

    python -m vargeno_tpu_torch.tools.bench_cohort [--donors 8]
        [--wgs-reads-per-donor 120e6] [--device cuda|cpu]

Streams the bench workload (``tools/bench.py``: its dataset and index, made
there and found through the same ``VGT_BENCH_*`` knobs) through one
CohortRunner as ``--donors`` donors, each the whole bench FASTQ: one index,
one device index and one tuned step shared by every sample, so per-donor
drain and fill overheads amortize as a real donor's thousands of batches
would. Auto-tune is on (``tune_batches=2``); the runner is warmed and tuned
on donor 0 for 4 batches, then its counts are reset. An overflow counter
left after escalation fails the tool. Reports cohort reads/s
and donors/hour at ``--wgs-reads-per-donor`` reads a donor (a 6X human WGS
donor is ~120M reads, the reference paper's NA12878 6X configuration) as one
JSON line, and writes every donor's per-site counts to
``<cache>/cohort_counts.npz`` (``ref_<name>``, ``alt_<name>``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config import GenoConfig
from . import bench


def run(wl: bench.Workload, donors: int, reads_per_donor: float,
        device) -> dict:
    from ..engine.cohort import CohortRunner
    from ..kernels.vote import vote_scan_records

    shape = bench.bench_config(wl)   # the bench's shapes, default caps
    cfg = GenoConfig(batch_reads=shape.batch_reads,
                     max_read_len=shape.max_read_len,
                     max_kmers_per_read=shape.max_kmers_per_read,
                     auto_tune=True, tune_batches=2)
    names = [f"d{i}" for i in range(donors)]
    with bench.stage("index load + device tables"):
        cohort = CohortRunner(bench.load_index(wl), names, cfg,
                              device=device)
        bench.sync(device)
    r = cohort._runner
    with bench.stage("warm + tune on donor 0"):
        cohort.consume_sample(names[0], wl.fq, limit_batches=4)
        cohort.counts[names[0]] = None
        cohort.stats[names[0]] = {}
        r.n_reads = 0
        bench.sync(device)

    launches = vote_scan_records.launches
    t0 = time.perf_counter()
    for name in names:
        cohort.consume_sample(name, wl.fq)
    bench.sync(device)
    dt = time.perf_counter() - t0
    launches = vote_scan_records.launches - launches
    ovf = {(name, k): v for name in names
           for k, v in cohort.stats[name].items() if "overflow" in k and v}
    if ovf:
        raise AssertionError(f"overflow counters left after escalation: "
                             f"{ovf}")
    counts = {}
    for name in names:
        rc, ac = cohort.counts[name]
        counts[f"ref_{name}"] = rc.cpu().numpy()
        counts[f"alt_{name}"] = ac.cpu().numpy()
    np.savez(wl.path("cohort_counts.npz"), **counts)
    rate = r.n_reads / dt
    return {
        "metric": "cohort_throughput",
        "donors": donors,
        "total_reads": r.n_reads,
        "seconds": round(dt, 2),
        "reads_per_sec": round(rate, 1),
        "donors_per_hour_at_6x_wgs": round(rate * 3600 / reads_per_donor,
                                           2),
        "device": bench.device_label(device),
        "vote_launches": launches,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.bench_cohort",
        description="cohort reads/s of the port on one card")
    ap.add_argument("--donors", type=int, default=8)
    ap.add_argument("--wgs-reads-per-donor", type=float, default=120e6,
                    help="read count used to convert to donors/hour")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    if bench.no_card(args.device):
        return 1
    print(json.dumps(run(bench.Workload.from_env(), args.donors,
                         args.wgs_reads_per_donor, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
