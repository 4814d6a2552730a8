"""Multi-process scaling: the multi-process runners on a local cluster (port
of ``tools/bench_scaling_mh.py``).

Spawns ``--procs`` worker processes of ``--devices-per-proc`` devices each,
joined through ``dist/multihost.py``, streams the same synthetic workload
through ``MultiHostGenoRunner`` (``dp``) or ``MultiHostDictGenoRunner``
(``routed``, route_factor 6.0), and reports the global rate of each mode.

    python -m vargeno_tpu_torch.tools.bench_scaling_mh [--procs 2]
        [--devices-per-proc 2] [--batches 6] [--batch-reads 2048]
        [--modes dp,routed] [--cpu] [--dist-backend nccl|gloo]
        [--cards DEV,...]

On the cards process p drives ``cuda:p*K .. cuda:p*K+K-1`` (K devices a
process) and the data group is nccl, which takes one process a card: a
cluster that needs more cards than are visible, or names one card twice, is
refused before any worker starts. ``--cards`` names the cluster's devices in
rank order, K a process; naming a card twice needs ``--dist-backend gloo``
(a check of the protocol on one card, not a scaling number). ``--cpu`` runs
host shards over gloo; without a card and without ``--cpu`` the tool stops
with an error.

The parent makes the dataset and index once (``testing.make_synthetic``:
the JAX tool's seed 123, 2 Mb, 5,000 SNPs, ``batch_reads * D * (batches +
2)`` reads) in ``<tempdir>/vgt_mh_scale_torch_<batch_reads>_<reads>``; the
workers load it. Each worker runs a warm batch, meets the others at a
barrier, times ``batches`` forward batches and the merge of the counts,
and gathers every rank's vote launches, peak device bytes (None for a host
device) and seconds to rank 0, which prints one JSON line a mode: the JAX
tool's ``mode``, ``procs``, ``devices`` and ``reads_per_sec``, and
``EXTRA_KEYS``. Each cluster runs under a time limit of 580 s; a failed
worker's output is shown and the tool exits non-zero. The last line is
``{"metric": "scaling_multiprocess", "results": [...]}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

from .bench_scaling import (MODES, ROUTE_FACTOR, cards_of, overflow_left,
                            peak_bytes, point_config, reset_peaks, sync)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CLUSTER_TIMEOUT = 580   # seconds, each cluster
EXTRA_KEYS = ("reads", "seconds", "backend", "cards", "vote_launches",
              "peak_bytes", "rank_seconds", "overflow")


def worker(a) -> int:
    from torch import distributed as dist

    from ..dist import multihost
    from ..index import store
    from ..kernels.vote import vote_scan_records

    cluster = multihost.initialize(f"tcp://{a.coord}", a.procs, a.pid,
                                   a.backend)
    mesh = multihost.ProcessMesh(cluster, a.devices.split(","))
    cards = cards_of(mesh.devices)
    reset_peaks(cards)
    index = store.load(a.prefix)
    cfg = point_config(a.batch_reads)
    if a.mode == "routed":
        runner = multihost.MultiHostDictGenoRunner(
            index, mesh, dataclasses.replace(cfg, route_factor=ROUTE_FACTOR))
    else:
        runner = multihost.MultiHostGenoRunner(index, mesh, cfg)
    runner.consume_fastq(a.fq, limit_batches=1)   # warm
    sync(cards)
    multihost.barrier(cluster)
    vote_scan_records.launches = 0
    t0 = time.perf_counter()
    n0 = runner.n_reads
    runner.consume_fastq(a.fq, limit_batches=a.batches)
    sync(cards)
    runner.host_counts()   # merged over every process, on the host
    dt = time.perf_counter() - t0
    mine = dict(cards=[str(c) for c in mesh.devices],
                vote_launches=vote_scan_records.launches,
                peak_bytes=peak_bytes(cards), seconds=dt)
    ranks = [None] * cluster.size
    dist.all_gather_object(ranks, mine, group=cluster.ctrl)
    if cluster.rank == 0:
        reads = runner.n_reads - n0
        print(json.dumps(dict(
            mode=a.mode, procs=a.procs, devices=mesh.size,
            reads_per_sec=round(reads / dt, 1), reads=reads, seconds=dt,
            backend=a.backend, cards=[r["cards"] for r in ranks],
            vote_launches=[r["vote_launches"] for r in ranks],
            peak_bytes=[r["peak_bytes"] for r in ranks],
            rank_seconds=[r["seconds"] for r in ranks],
            overflow=overflow_left(runner))), flush=True)
    multihost.shutdown(cluster)
    return 0


def cluster_cards(args) -> list:
    """Every rank's devices, K a rank; ValueError for a cluster that
    cannot run (checked before any worker starts)."""
    P, K = args.procs, args.devices_per_proc
    if P < 1 or K < 1:
        raise ValueError("--procs and --devices-per-proc take N >= 1")
    if args.cpu:
        if args.dist_backend == "nccl" or args.cards:
            raise ValueError("--cpu runs host shards over gloo (no "
                             "--dist-backend nccl, no --cards)")
        return [["cpu"] * K for _ in range(P)]
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device is available (pass --cpu to run "
                         "host shards over gloo)")
    n = torch.cuda.device_count()
    names = (args.cards.split(",") if args.cards
             else [f"cuda:{i}" for i in range(P * K)])
    if len(names) != P * K:
        raise ValueError(f"{len(names)} --cards named for {P} processes x "
                         f"{K} devices")
    devs = [torch.device(c) for c in names]
    if any(d.type != "cuda" or (d.index or 0) >= n for d in devs):
        raise ValueError(f"the cluster needs the cards {names}; "
                         f"{n} CUDA device(s) are visible")
    if (args.dist_backend or "nccl") == "nccl" \
            and len({d.index or 0 for d in devs}) < len(devs):
        raise ValueError(f"nccl takes one process a card and the cards "
                         f"{names} repeat (a one-card check names "
                         f"--dist-backend gloo)")
    return [names[p * K:(p + 1) * K] for p in range(P)]


def build_dataset(batch_reads: int, n_reads: int):
    """The synthetic index and FASTQ, made once a (batch, read count) in
    the temporary directory. Returns (index prefix, FASTQ)."""
    from ..index import store
    from ..testing import make_synthetic

    cache = os.path.join(tempfile.gettempdir(),
                         f"vgt_mh_scale_torch_{batch_reads}_{n_reads}")
    prefix, fq = os.path.join(cache, "idx"), os.path.join(cache, "reads.fq")
    if not os.path.exists(os.path.join(cache, "ready")):
        os.makedirs(cache, exist_ok=True)
        index, _, _, _ = make_synthetic(
            seed=123, tmpdir=cache, sizes=(2_000_000,), n_snps=5_000,
            n_reads=n_reads)
        store.save(prefix, index)
        open(os.path.join(cache, "ready"), "w").close()
    return prefix, fq


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_cluster(args, mode: str, cards: list, backend: str, prefix: str,
                fq: str) -> dict:
    """One mode's cluster; returns rank 0's line. A worker that fails or
    outlasts CLUSTER_TIMEOUT fails the tool, its output shown."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vargeno_tpu_torch.tools.bench_scaling_mh",
         "--worker", "--coord", f"localhost:{port}", "--procs",
         str(args.procs), "--pid", str(pid), "--devices", ",".join(devs),
         "--backend", backend, "--prefix", prefix, "--fq", fq, "--mode",
         mode, "--batches", str(args.batches), "--batch-reads",
         str(args.batch_reads)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid, devs in enumerate(cards)]
    deadline = time.monotonic() + CLUSTER_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if outs is None or any(p.returncode for p in procs):
        for pid, o in enumerate(outs or []):
            print(f"--- worker {pid} (exit {procs[pid].returncode}) ---\n"
                  f"{o[-3000:]}", file=sys.stderr)
        raise SystemExit(f"worker failed ({mode})" if outs is not None else
                         f"the {mode} cluster did not finish within "
                         f"{CLUSTER_TIMEOUT} s")
    got = [json.loads(line) for line in outs[0].splitlines()
           if line.startswith("{")]
    if len(got) != 1:
        raise SystemExit(f"rank 0 printed {len(got)} result lines ({mode})")
    return got[0]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--worker" in argv:
        ap = argparse.ArgumentParser()
        ap.add_argument("--worker", action="store_true")
        for flag in ("--coord", "--devices", "--backend", "--prefix",
                     "--fq", "--mode"):
            ap.add_argument(flag)
        for flag in ("--procs", "--pid", "--batches", "--batch-reads"):
            ap.add_argument(flag, type=int)
        return worker(ap.parse_args(argv))
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.bench_scaling_mh",
        description="global reads/s of the multi-process runners")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--batch-reads", type=int, default=2048)
    ap.add_argument("--modes", default="dp,routed")
    ap.add_argument("--cpu", action="store_true",
                    help="host shards over gloo instead of cards")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None, help="the data group's backend (nccl on "
                                       "the cards, gloo with --cpu)")
    ap.add_argument("--cards", default=None, metavar="DEV[,DEV...]",
                    help="the cluster's cards in rank order (default "
                         "cuda:0 .. cuda:procs*K-1)")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    try:
        if any(m not in MODES for m in modes):
            raise ValueError(f"--modes {args.modes}: each is one of {MODES}")
        cards = cluster_cards(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    backend = args.dist_backend or ("gloo" if args.cpu else "nccl")
    D = args.procs * args.devices_per_proc
    prefix, fq = build_dataset(args.batch_reads,
                               args.batch_reads * D * (args.batches + 2))
    results = []
    for mode in modes:
        got = run_cluster(args, mode, cards, backend, prefix, fq)
        results.append(got)
        print(json.dumps(got), flush=True)
    print(json.dumps({"metric": "scaling_multiprocess", "results": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
