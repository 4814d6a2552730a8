"""Multi-card scaling efficiency of both mesh modes (port of
``tools/bench_scaling.py``).

Measures global reads/s at mesh sizes 1, 2, 4, 8, ... up to ``--devices``
for the data-parallel runner (replicated index, ``dist/sharding.py``) and
the sharded dictionary (all-to-all routed probes, ``dist/sharded_dict.py``),
and reports each size's efficiency against linear scaling of the mode's
per-device rate at its first size (routing needs 2 shards, so the routed
mode starts there). On the cards this measures the >= 85 % scaling target
of one host (BASELINE.md); with ``--cpu`` every "device" is a host shard
sharing the same cores, so the numbers only check the code path.

    python -m vargeno_tpu_torch.tools.bench_scaling [--devices N]
        [--batches 8] [--batch-reads 2048] [--modes dp,routed] [--cpu]

The mesh at size d is ``cuda:0 .. cuda:d-1`` (``--devices`` 0: every
visible card), or d host shards with ``--cpu``; without a card and without
``--cpu`` the tool stops with an error. The workload is the JAX tool's
synthetic draw (``testing.make_synthetic``: seed 123, one 2 Mb chromosome,
5,000 SNPs, ``batch_reads * max(sizes) * (batches + 1)`` reads). Each point
builds its runner, runs one warm batch, then times ``batches`` forward
batches from the start of the file: the window ends when every card of the
mesh has synchronised and the counts are on the host. As in the JAX tool,
the runner's ``limit_batches`` counts the host loop's batches, its retry
batches of queued reverse complements among them, so the window's reads
are its forward batches' (and a forward batch is short at the end of each
256 MiB window the FASTQ reader takes). One JSON line a point, then ``{"metric":
"scaling", "results": [...]}``. A point carries the JAX tool's keys and
``EXTRA_KEYS``: the reads in the window, its seconds, its host-loop batches
(forward and retry, the final drain of the retry queue included), the vote
kernel's launches in it, each card's peak allocated bytes (None for a host
device) and the overflow counters left after escalation.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import tempfile
import time

import torch

from ..config import GenoConfig
from ..dist.sharded_dict import ShardedDictGenoRunner
from ..dist.sharding import ShardedGenoRunner, make_mesh
from ..kernels.vote import vote_scan_records

SIZES = (1, 2, 4, 8, 16, 32)
MODES = ("dp", "routed")
ROUTE_FACTOR = 6.0   # the JAX tool's routed lane capacity
EXTRA_KEYS = ("reads", "seconds", "window_batches", "vote_launches",
              "peak_bytes", "overflow")


def sizes_upto(max_devices: int) -> list:
    return [d for d in SIZES if d <= max_devices]


def point_config(batch_reads: int) -> GenoConfig:
    """The JAX tool's engine config."""
    return GenoConfig(batch_reads=batch_reads, max_read_len=128,
                      max_kmers_per_read=4)


def make_runner(index, mode: str, mesh, cfg: GenoConfig):
    if mode == "routed":
        return ShardedDictGenoRunner(
            index, mesh, dataclasses.replace(cfg, route_factor=ROUTE_FACTOR))
    return ShardedGenoRunner(index, mesh, cfg)


def cards_of(devices) -> list:
    """The distinct devices of ``devices``, in order."""
    return list(dict.fromkeys(torch.device(d) for d in devices))


def reset_peaks(cards) -> None:
    """Zero each card's peak allocated bytes (an allocation first: the
    allocator of a card this process has not used yet takes no reset)."""
    for c in cards:
        if c.type == "cuda":
            torch.zeros(1, device=c)
            torch.cuda.reset_peak_memory_stats(c)


def peak_bytes(cards) -> list:
    return [torch.cuda.max_memory_allocated(c) if c.type == "cuda" else None
            for c in cards]


def sync(cards) -> None:
    for c in cards:
        if c.type == "cuda":
            torch.cuda.synchronize(c)


def release() -> None:
    """Free a dropped runner's tensors before the next one is built."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def overflow_left(runner) -> dict:
    return {k: v for k, v in runner.stats_totals.items()
            if "overflow" in k and v}


def run_point(index, fq: str, mode: str, devices, cfg: GenoConfig,
              batches: int):
    """One point: ``mode``'s runner over a mesh of ``devices`` (named: a
    card may repeat), a warm batch, then ``batches`` forward batches timed
    from the start of ``fq``. Returns (the point's result without its
    efficiency, the runner)."""
    cards = cards_of(devices)
    reset_peaks(cards)
    runner = make_runner(index, mode, make_mesh(devices=list(devices)), cfg)
    runner.consume_fastq(fq, limit_batches=1)   # warm
    sync(cards)
    vote_scan_records.launches = 0
    t0 = time.perf_counter()
    n0, b0 = runner.n_reads, runner.meter.batches
    runner.consume_fastq(fq, limit_batches=batches)
    sync(cards)
    runner.host_counts()   # the counts on the host end the window
    dt = time.perf_counter() - t0
    reads = runner.n_reads - n0
    d = len(devices)
    return dict(mode=mode, devices=d, reads_per_sec=round(reads / dt, 1),
                per_device=round(reads / dt / d, 1), reads=reads,
                seconds=dt, window_batches=runner.meter.batches - b0,
                vote_launches=vote_scan_records.launches,
                peak_bytes=peak_bytes(cards),
                overflow=overflow_left(runner)), runner


def with_efficiency(points: list) -> list:
    """Each point's efficiency against linear scaling of the first point's
    per-device rate (the points of one mode, in size order)."""
    base = None
    for p in points:
        if base is None:
            base = p["reads_per_sec"] / p["devices"]
        p["efficiency"] = round(p["reads_per_sec"] / (base * p["devices"]),
                                3)
    return points


def mesh_devices(d: int, cpu: bool) -> list:
    return ["cpu"] * d if cpu else [f"cuda:{i}" for i in range(d)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.bench_scaling",
        description="scaling efficiency of both mesh modes")
    ap.add_argument("--devices", type=int, default=0,
                    help="max devices (0 = every visible card)")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-reads", type=int, default=2048)
    ap.add_argument("--modes", default="dp,routed")
    ap.add_argument("--cpu", action="store_true",
                    help="host shards instead of cards (checks the code "
                         "path; no scaling number)")
    args = ap.parse_args(argv)
    if args.cpu:
        maxd = args.devices or 8
    elif not torch.cuda.is_available():
        print("error: no CUDA device is available (pass --cpu to run host "
              "shards)", file=sys.stderr)
        return 1
    else:
        maxd = args.devices or torch.cuda.device_count()
        if maxd > torch.cuda.device_count():
            print(f"error: --devices {maxd} but {torch.cuda.device_count()} "
                  f"CUDA device(s) are visible", file=sys.stderr)
            return 1
    sizes = sizes_upto(maxd)
    modes = args.modes.split(",")
    bad = [m for m in modes if m not in MODES]
    if bad or not sizes:
        print(f"error: modes {bad} are not among {MODES}, or no size fits "
              f"--devices {maxd}", file=sys.stderr)
        return 1

    from ..testing import make_synthetic

    cfg = point_config(args.batch_reads)
    results = []
    with tempfile.TemporaryDirectory(prefix="vgt_scaling_") as tmp:
        index, _, _, fq = make_synthetic(
            seed=123, tmpdir=tmp, sizes=(2_000_000,), n_snps=5_000,
            n_reads=args.batch_reads * max(sizes) * (args.batches + 1))
        for mode in modes:
            points = []
            for d in sizes:
                if mode == "routed" and d == 1:
                    continue   # routing needs >= 2 shards
                got, runner = run_point(index, fq, mode,
                                        mesh_devices(d, args.cpu), cfg,
                                        args.batches)
                del runner
                release()
                points.append(got)
                with_efficiency(points)
                print(json.dumps(got), flush=True)
            results += points
    print(json.dumps({"metric": "scaling", "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
