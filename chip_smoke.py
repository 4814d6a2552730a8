#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR | --all-cards]

``--all-cards`` runs only the build and phase ``cards`` (below) on every
visible card (2 or more).

``--parent DIR`` names a checkout of an earlier commit of this repository,
unpacked into a directory inside this one (``git archive <commit> | tar -x
-C .parent``, say): the real phase then profiles one forward step of that
checkout's package too (device operations, time on the card, the vote
kernel's own time there and on the kernel phase's random streams) and times
its (E, B) vote entry, each checkout in a process of its own, and prints
both side by side. Without it the run shows nothing of the parent, and the
vote's ``ms_before`` on the kernels line is null.

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device  -- require CUDA; print the card's name and power limit (as
   nvidia-smi reports them) and the torch / CUDA / numpy versions.
2. build   -- compile both kernels (nvcc, sm_90a) and the native host
   library (g++) from the sources in this checkout; print the seconds and
   ptxas' register lines.
3. kernel  -- each hand-written kernel against its plain PyTorch version on
   the card, exact equality (integers), median times of both from CUDA
   events, and the least time the card could take for the same work.
   The vote kernel on random event streams with ragged per-read counts,
   packed as the step packs them ((B, E) views of (B, E + 1)-strided int64
   records), at (E, B, C) = (96, 32768, 32), (96, 32768, 64), (8, 32768,
   32) (the auto-tuned shape), (32, 4096, 16), and at the wide tables that
   overflow escalation reaches, (1200, 4096, 1024) and (2000, 1024, 520)
   (global-workspace table); (32, 4096, 16) and (2000, 1024, 520) must
   overflow their candidate tables. Both entries (records, and the (E, B)
   layout) against both plain versions. Timed apart: the bare launch on
   pre-built records, the records entry, the (E, B) entry. The
   row-gather kernel at (N, R, W) = (65536, 2097152, 32) (the shape of the
   TPU kernel it replaces), (4194304, 2097152, 32), (524288, 524288, 128),
   with every index equal, with N = 1, and on a permutation index (N = R
   distinct rows of 128 B and of 512 B: the card's rate on random rows);
   the wrapper, which launches the ring kernel for many 128 B rows and the
   direct-load kernel for the rest, beside each kernel named outright, and
   both kernels over N = 2**16 .. 2**22 at 128 B rows (where the choice
   between them should lie).
4. bench   -- the gather-rate bench (tools/bench_gather.py) on the card at
   its full table size: the main path of the row-gather kernel, whose
   launches are counted here. Prints its JSON line.
5. golden  -- index the mini fixture and genotype it on the card at
   batch_reads=512: at default capacities; with 640 events and 1024
   candidates a read; with both orientations inline (non-queued); with
   auto-tune on (it must fire); stopped after 8 batches with a checkpoint
   every 4 and resumed by a second runner; as the first sample of a
   two-sample cohort (whose second sample stops after 2 batches and must
   differ); the long-read fixture (101 to 992 bases) at the shapes the CLI
   picks from a FASTQ peek, against golden_long_output.vcf. Each VCF must
   be byte-identical to the reference binary's golden output, with the
   vote kernel launched and no capacity overflow left after escalation.
   Then the filt index: its geno VCF must equal golden_filt_output.vcf.
6. mesh   -- both multi-device runners on the mini fixture, golden each
   time: the replicated-index mesh and the sharded dictionary at D = 1 and
   D = 2 (D = 2 names cuda:0 twice: it checks the routing and lockstep on
   one card and is not a deployment), the routed one from route_factor
   0.05 (must escalate), cohort on D = 2, and a single-device checkpoint
   resumed on the D = 2 sharded dictionary.
7. real    -- the benchmark workload (one 48 Mb chromosome, 500,000 SNPs,
   262,144 101 bp reads at err_frac=0.15, seed 20260817) at
   batch_reads=32768 and ht_target_load=0.24. This is the main path of
   the vote kernel, whose launches are counted here. Prints index build /
   load seconds, end-to-end reads/s (index load excluded), peak device
   memory and the run's counters; the roofline report of that pass from
   its reads/s, its measured retry fraction and the bench phase's rates; a
   second pass with auto-tune on (reads/s of both, the tuned capacities,
   equal pileup counts required); the first two batches are re-run with
   the plain vote and must give the same counts; the bare vote launch is
   timed on the first batch's own records; the device operations of one
   vote call (at most 3) and of one forward step are counted with
   torch.profiler, the step in a process of its own, with the vote
   kernel's own time there.
8. routed -- the same workload, untuned, through the sharded-dictionary
   runner at D = 1 and D = 2 once the hash-table index is freed: counts
   equal to the hash-table pass's, no overflow, the vote kernel launched;
   reads/s, escalations, route_overflow, peak device memory, the index's
   device bytes; the device operations of one routed forward step (own
   process); the oracle spot check (2,048 reads through the sequential
   oracle and the D = 1 runner, all 500,000 sites' counts equal).
9. multihost -- multi-process geno (dist/multihost.py), each process a
   fresh interpreter (``--mh-worker``), each cluster under its own time
   limit: the mini runs (data-parallel queued, inline dual, sharded
   dictionary, forced escalation, a checkpoint stop) on 2 processes naming
   cuda:0 over gloo and on 1 process over nccl, golden each, the 2-process
   checkpoint resumed by a single-process runner; then the 48 Mb workload
   through the 2-process sharded dictionary on cuda:0 over gloo, its VCF
   equal to the hash-table pass's; vote launches, peak device memory and
   index bytes per process. Two processes on one card check the protocol
   and a shard's memory; they are not a deployment.
10. fuzz  -- the differential fuzzer (tools/fuzz_diff.py) on seeds fixed
   in advance: seeds 0-23 through GenoRunner as each seed's draw says, and
   the same fixtures through the replicated mesh at D = 2 and the sharded
   dictionary at D = 1 and D = 2; seeds 0 and 1 on 2 processes x 1 shard
   over gloo (replicated and sharded dictionary); seed 0 at VGT_FUZZ_BIG
   scale (307,000 reads) through the tool's command line in a process of
   its own, beside the rest. Each run's counts must equal the sequential
   oracle's at every site, with no overflow left and the vote kernel
   launched. Prints a line a runner (seeds, mismatches, escalations, vote
   launches, seconds) and the phase's seconds.
11. genome -- genome scale: a 300 Mb genome, 3,000,000 SNPs, 262,144 reads
   of 101 bp at batch_reads=32768 (the JAX package's mid-scale point).
   (a) synthesis and the index build (tools/rehearse_wgs.py, host-only)
   and (e) the kill / resume endurance over 2,097,152 more reads
   (tools/endurance_wgs.py: three fresh interpreters on the sharded
   dictionary at D = 1, leg B SIGKILLed at a checkpoint past half the
   stream, leg C's VCF byte-identical to leg A's) run in a session of their
   own beside phases 5, 6 and 10, (e) only once phases 3 and 4 are over;
   then (b) the hash-table runner (host derivation of its 34 GB table,
   upload, reads/s, peak device memory, index bytes, the bare vote launch
   on a 300 Mb step's records), (c) the sharded dictionary at D = 1, its
   counts equal to (b)'s at every site, and (d) the oracle spot check
   (2,048 sampled reads through the D = 1 runner and the sequential
   oracle, every site equal). No overflow may be left and the vote kernel
   must launch in every run.

Phase order: 1, 2, then 3-6 and 10 beside genome (a) and (e) and beside
the making of phase 7's dataset and index (a process of its own, host
only), then 7-9 and genome (b)-(d); phases 7-9 never run beside those
processes, so their reads/s stays comparable with earlier runs. The log
gives each phase's seconds. A JSON line ``{"mesh": ...}`` carries phase 8's and phase 9's
numbers, ``{"fuzz": ...}`` phase 10's, ``{"genome": ...}`` phase 11's.

cards (``--all-cards`` only) -- the 48 Mb workload, untuned, two passes a
   runner (the second warm), every VCF equal to the one-card hash-table
   pass's: one process driving every card (replicated index: the shard
   steps in turn from one thread; sharded dictionary: a thread a shard)
   against one process a card (replicated index over nccl; sharded
   dictionary over nccl and over gloo). Prints a ``{"cards": ...}`` line. The last two
lines are a JSON object describing each kernel and the
result line ``{"ok": true, "device": {...}}``. The dataset and index are
cached under ``.smoke_cache/`` next to this file.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures", "mini")
CACHE = os.path.join(ROOT, ".smoke_cache")

# bench.py's workload
GENOME_MB, N_SNPS, N_READS, READ_LEN = 48, 500_000, 262_144, 101
ERR_FRAC, SEED, BATCH, HT_LOAD = 0.15, 20260817, 32768, 0.24
# (E, B, C, must overflow); the first is the main path's default shape
KERNEL_SHAPES = [(96, 32768, 32, False), (96, 32768, 64, False),
                 (8, 32768, 32, False), (32, 4096, 16, True),
                 (1200, 4096, 1024, False), (2000, 1024, 520, True)]
VOTE_TIMED = [(96, 32768, 32), (96, 32768, 64), (8, 32768, 32),
              (1200, 4096, 1024)]
# (N, R, W, index: "random", "same" or "perm"); the second is the one the
# kernels line times
GATHER_SHAPES = [(65536, 2097152, 32, "random"),
                 (4194304, 2097152, 32, "random"),
                 (2097152, 2097152, 32, "perm"),
                 (100000, 2097152, 32, "same"), (1, 2097152, 32, "random"),
                 (524288, 524288, 128, "random"),
                 (524288, 524288, 128, "perm")]
GATHER_MAIN = GATHER_SHAPES[1][:3]
# N of both gather kernels side by side, on the (2097152, 32) table
GATHER_CROSSOVER = [1 << p for p in range(16, 23)]
DEVICE = "cuda"
# the card's published peaks (H100 SXM data sheet): memory bytes/s, and
# operations/s outside the tensor cores (the float32 rate, taken for the
# kernels' 32-bit integer operations too)
PEAK_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12
# phase fuzz: the seeds of the differential fuzzer, fixed in advance
FUZZ_SEEDS = range(24)
FUZZ_MH_SEEDS = (0, 1)   # also on 2 processes
FUZZ_BIG_SEED = 0        # also at VGT_FUZZ_BIG scale
# phase genome: the JAX package's mid-scale point (docs/WORKFLOWS.md:56-60)
WGS_MB, WGS_SNPS, WGS_READS = 300, 3_000_000, 262_144
WGS_EXTRA_READS, WGS_SPOT = 2_097_152, 2048   # endurance stream, spot check
WGS_CHECKPOINT_EVERY = 8   # endurance checkpoints: every 262,144 reads


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + r.stderr)
    return "; ".join(r.stdout.strip().splitlines())


# ----------------------------------------------------------------------
def random_events(E, B, C, seed):
    """Event streams with repeating idx values (2C distinct per read, a
    few >= 2**31) and ragged counts; events past ev_n are invalid. Returns
    the (E, B) quartet with ev_n, and the same events as the step's
    records: (B, E) views of (B, E + 1)-strided int64 words whose meta
    carries ``src`` bits from bit 7 up, with the unclamped count (full
    reads count past E)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2 * C, (E, B)).astype(np.int64)
    idx[rng.random((E, B)) < 0.05] |= 1 << 31
    k = rng.integers(0, 4, (E, B)).astype(np.int32)
    isnb = rng.random((E, B)) < 0.3
    ev_n = rng.integers(0, E + 1, B).astype(np.int32)
    valid = (rng.random((E, B)) < 0.8) & (np.arange(E)[:, None]
                                          < ev_n[None, :])
    dev = torch.device("cuda")
    quartet = [torch.from_numpy(a).to(dev) for a in (idx, k, isnb, valid)]
    ev_n = torch.from_numpy(ev_n).to(dev)
    rec_idx = torch.zeros((B, E + 1), dtype=torch.int64, device=dev)
    rec_meta = torch.zeros_like(rec_idx)
    rec_idx[:, :E] = quartet[0].t()
    rec_meta[:, :E] = (quartet[1].t().long() | (quartet[2].t().long() << 5)
                       | (quartet[3].t().long() << 6)
                       | (torch.arange(B * E, device=dev).reshape(B, E) << 7))
    total = ev_n.long()
    total[total == E] += 3
    return quartet, ev_n, (rec_idx[:, :E], rec_meta[:, :E], total)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the operation rate."""
    t_b, t_o = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def device_ops(fn):
    """(n, records): the device operations (kernels, copies, memsets) that
    one call of ``fn`` puts on the card, and the (name, microseconds)
    records of device operations that torch.profiler kept. ``n`` is counted
    on the host side, from the CUDA runtime's launch, copy and memset calls
    inside the call's span, which is exact; the device-side records of a
    trace can come back incomplete, so they are handed on as found (those
    of one warm-up call inside the trace included)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function("smoke_call"):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    span = next(e for e in host if e.name == "smoke_call").time_range
    launch = re.compile(r"^cu(da)?(LaunchKernel|Memcpy|Memset)")
    n = sum(1 for e in host if launch.match(e.name)
            and span.start <= e.time_range.start <= span.end)
    if n <= 0:
        raise RuntimeError("torch.profiler recorded no device operation")
    # the span is mirrored on the device's timeline: not an operation
    records = [(e.name, e.time_range.elapsed_us()) for e in events
               if e.device_type == DeviceType.CUDA and e.name != "smoke_call"]
    return n, records


def count_device_ops(fn) -> int:
    return device_ops(fn)[0]


def kernel_us(fn, name: str, traces: int = 3):
    """Median microseconds of the device operations named ``name`` in the
    records that ``traces`` profiler traces of ``fn`` kept (two calls a
    trace), or None if none was kept: a short kernel's own time on the
    card, which neither CUDA events round one call (host launch latency)
    nor a stream of calls (the host's time to issue one) can show."""
    import statistics

    us = [t for _ in range(traces) for n, t in device_ops(fn)[1]
          if name in n]
    return statistics.median(us) if us else None


def stream_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Milliseconds a call of ``fn`` in a stream of calls: CUDA events
    round ``n`` calls in a row, over ``n``; the median of ``reps`` such
    runs. With the calls queued behind each other the host's launch
    latency, which a pair of events round one short call includes, is
    hidden, so for a bare launch this is the kernel's own time (or the
    host's time to issue a launch, if that is longer)."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def raw_vote(records, C):
    """A closure that launches the bare vote kernel on ``records`` into
    outputs allocated once, and those outputs."""
    import torch

    from vargeno_tpu_torch.kernels import vote

    ev_idx = records[0]
    B, E = ev_idx.shape
    dev = ev_idx.device
    width = max(1, min(C, E))
    process = torch.empty(B, dtype=torch.bool, device=dev)
    target = torch.empty(B, dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.int64, device=dev)
    ws = None
    if width > vote.load_library().vgt_vote_reg_max_c():
        ws = torch.empty((3, B, width), dtype=torch.int32, device=dev)

    def go():
        vote.launch_records(*records, width, process, target, ovf, ws)
    return go, (process, target, ovf)


def vote_bound(total, E, B, C):
    """The kernel loads 8 B a record (the low 32-bit word of each of its
    two int64 words; the high halves lie in the same DRAM sectors and are
    fetched with them, which the bound does not count) up to each read's
    clamped count and 8 B of count a read, and writes 9 B a read (and the
    8 B counter); an event is compared with up to min(C, E) slots and
    updates ~16 words of state."""
    n_ev = int(total.clamp(0, E).sum())
    return n_ev, bound(n_ev * 8 + B * 17 + 8, n_ev * (min(C, E) + 16))


def time_vote_on_step(phase: str, card: str, records, C) -> dict:
    """The bare vote launch on a step's own records (real reads, real
    event counts): exactly equal to the plain version, then timed between
    CUDA events round one call and in a stream of 50 launches, beside its
    bound. Prints one line; returns the numbers."""
    import torch

    from vargeno_tpu_torch.kernels.vote import vote_scan_records_plain
    from vargeno_tpu_torch.utils.profiling import device_ms

    B, E = records[0].shape
    go, raw_out = raw_vote(records, C)
    go()
    want = vote_scan_records_plain(*records, C)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(raw_out, want)):
        raise AssertionError(f"{phase}: bare vote launch != plain on the "
                             f"first batch's records")
    n_ev, (b_ms, b_by) = vote_bound(records[2], E, B, C)
    raw_ms = device_ms(go, DEVICE, reps=20)
    st_ms = stream_ms(go)
    log(phase, f"[{card}] vote on the first forward batch's records, (E, "
               f"B, C) = {(E, B, C)}, {n_ev} events (most in a read "
               f"{int(records[2].max())}), row stride "
               f"{records[0].stride(0)}: bare launch {raw_ms:.4f} ms "
               f"between CUDA events round one call, {st_ms:.4f} "
               f"ms a launch in a stream of 50 (no less than the host's "
               f"time to issue one), bound {b_ms:.4f} ms by {b_by}")
    return dict(shape=(E, B, C), events=n_ev, raw_ms=raw_ms, stream_ms=st_ms,
                bound_ms=b_ms, bound_by=b_by)


def phase_kernel_vote():
    import torch

    from vargeno_tpu_torch.kernels.vote import (vote_scan, vote_scan_plain,
                                                vote_scan_records,
                                                vote_scan_records_plain)
    from vargeno_tpu_torch.utils.profiling import device_ms

    timing = {}
    max_err = 0
    for E, B, C, must_overflow in KERNEL_SHAPES:
        quartet, ev_n, records = random_events(E, B, C, seed=E * 1000 + C)
        if records[0].stride() != (E + 1, 1):
            raise AssertionError("the records lost their row stride")
        got = vote_scan_records(*records, C)
        via_eb = vote_scan(*quartet, C, ev_n)
        want = vote_scan_records_plain(*records, C)
        want_eb = vote_scan_plain(*quartet, C, ev_n)
        go, raw_out = raw_vote(records, C)
        go()
        torch.cuda.synchronize()
        for entry, res in (("records entry", got), ("(E, B) entry", via_eb),
                           ("bare launch", raw_out),
                           ("plain (E, B)", want_eb)):
            for name, g, w in zip(("process", "target", "cand_overflow"),
                                  res, want):
                err = int((g.long() - w.long()).abs().max())
                max_err = max(max_err, err)
                if err or g.dtype != w.dtype:
                    raise AssertionError(
                        f"vote {entry} != plain records version at "
                        f"{(E, B, C)}: {name} max err {err}, {g.dtype}")
        ovf = int(got[2])
        if must_overflow and ovf <= 0:
            raise AssertionError(f"{(E, B, C)} did not overflow")
        n_ev, (b_ms, b_by) = vote_bound(records[2], E, B, C)
        msg = (f"vote (E, B, C) = {(E, B, C)}: both entries and the bare "
               f"launch match the plain versions exactly (processed "
               f"{int(got[0].sum())}, cand_overflow {ovf})")
        if (E, B, C) in VOTE_TIMED:
            raw_ms = device_ms(go, DEVICE, reps=20)
            ms = device_ms(lambda: vote_scan_records(*records, C), DEVICE,
                           reps=20)
            eb_ms = device_ms(lambda: vote_scan(*quartet, C, ev_n), DEVICE,
                              reps=20)
            plain_ms = device_ms(
                lambda: vote_scan_records_plain(*records, C), DEVICE, reps=3)
            own_us = kernel_us(go, "vote_kernel")
            kernel_ms = stream_ms(go)
            entry_stream = stream_ms(lambda: vote_scan_records(*records, C))
            eb_stream = stream_ms(lambda: vote_scan(*quartet, C, ev_n))
            timing[E, B, C] = dict(ms=ms, kernel_ms=kernel_ms,
                                   raw_launch_ms=raw_ms, eb_entry_ms=eb_ms,
                                   plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by)
            msg += (f"; between CUDA events round one call (host launch "
                    f"latency included): bare launch {raw_ms:.4f} ms, "
                    f"records entry {ms:.4f} ms, (E, B) entry {eb_ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms; a call in a stream of 50 "
                    f"calls: bare launch (the kernel's own time) "
                    f"{kernel_ms:.4f} ms, records entry {entry_stream:.4f} "
                    f"ms, (E, B) entry {eb_stream:.4f} ms; "
                    f"bound {b_ms:.4f} ms by {b_by} for its {n_ev} events "
                    f"at 8 B loaded a record; the kernel's own record in "
                    f"a torch.profiler trace: "
                    + ("none kept" if own_us is None else f"{own_us:.1f} us"))
        log("kernel", msg)
    return timing, max_err


def phase_kernel_gather():
    import numpy as np
    import torch

    from vargeno_tpu_torch.kernels import gather
    from vargeno_tpu_torch.kernels.gather import (gather_rows_sum,
                                                  gather_rows_sum_plain)
    from vargeno_tpu_torch.utils.profiling import device_ms

    rng = np.random.default_rng(11)
    dev = torch.device(DEVICE)
    uses_ring = gather.load_library().vgt_gather_uses_ring
    timing = {}
    max_err = 0
    tables: dict = {}
    out = torch.zeros((), dtype=torch.int32, device=dev)

    def bare(idx, kernel):
        """The bare launch of the kernel named, into a zeroed word."""
        out.zero_()
        gather.launch(table, idx, out, kernel)
        return out

    for N, R, W, kind in GATHER_SHAPES:
        if (R, W) not in tables:
            tables.clear()   # one 256 MiB table on the card at a time
            tables[R, W] = torch.from_numpy(rng.integers(
                0, 2**32, (R, W), dtype=np.uint32).view(np.int32)).to(dev)
        table = tables[R, W]
        if kind == "perm":
            idx_np = rng.permutation(R).astype(np.int32)
        else:
            idx_np = rng.integers(0, R, N, dtype=np.int32)
        if kind == "same":
            idx_np[:] = idx_np[0]
        for dtype in (torch.int64, torch.int32):
            idx = torch.from_numpy(idx_np).to(dev).to(dtype)
            want = int(gather_rows_sum_plain(table, idx))
            for name, got in (("wrapper", gather_rows_sum(table, idx)),
                              ("ring", bare(idx, "ring")),
                              ("direct", bare(idx, "direct"))):
                err = abs(int(got) - want)
                max_err = max(max_err, err)
                if err:
                    raise AssertionError(
                        f"gather kernel ({name}) != plain at {(N, R, W)} "
                        f"{kind} {dtype}: {int(got)} vs {want}")
        chosen = "ring" if uses_ring(N, W) else "direct"
        ms = device_ms(lambda: gather_rows_sum(table, idx), DEVICE, reps=20)
        ring_ms = device_ms(lambda: bare(idx, "ring"), DEVICE, reps=20)
        direct_ms = device_ms(lambda: bare(idx, "direct"), DEVICE, reps=20)
        plain_ms = device_ms(lambda: gather_rows_sum_plain(table, idx),
                             DEVICE, reps=5)
        # the one PyTorch call for the same function: gather, then reduce
        lib_ms = device_ms(
            lambda: table.index_select(0, idx).sum(dtype=torch.int64),
            DEVICE, reps=5)
        # each input read once: the rows these indices name (a row named
        # twice is one row of the table, W * 4 B), 4 B an index as timed
        # (int32), 4 B out; one add a gathered word
        n_rows = int(torch.unique(idx).numel())
        b_ms, b_by = bound(n_rows * W * 4 + N * idx.element_size() + 4, N * W)
        msg = (f"gather (N, R, W) = {(N, R, W)} ({kind} index): the wrapper "
               f"(which launches the {chosen} kernel here), the ring and "
               f"the direct kernel match plain exactly (sum {want}); "
               f"between CUDA events round one call: wrapper {ms:.4f} ms, "
               f"ring {ring_ms:.4f} ms, direct {direct_ms:.4f} ms, plain "
               f"{plain_ms:.4f} ms, index_select+sum {lib_ms:.4f} ms; bound "
               f"{b_ms:.4f} ms by {b_by} for its {n_rows} distinct rows")
        if kind != "same" and N >= 1 << 19:   # the large shapes
            ring_st = stream_ms(lambda: bare(idx, "ring"), n=20)
            direct_st = stream_ms(lambda: bare(idx, "direct"), n=20)
            msg += (f"; a launch in a stream of 20: ring {ring_st:.4f} ms, "
                    f"direct {direct_st:.4f} ms")
            if kind == "perm":
                # every row distinct: the rate of random rows out of DRAM
                msg += (f"; {W * 4} B random rows at "
                        f"{N * W * 4 / (ring_st * 1e-3):.4g} B/s with the "
                        f"ring, {N * W * 4 / (direct_st * 1e-3):.4g} B/s "
                        f"direct, by the stream's time (the card's memory "
                        f"rate: {PEAK_BYTES_S:.4g} B/s)")
        if kind != "perm":
            timing[N, R, W] = dict(
                ms=ms, ms_before=direct_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                distinct_rows=n_rows, kernel=chosen)
        log("kernel", msg)
        if (N, R, W) == GATHER_MAIN:
            # both kernels over N at 128 B rows: where the choice should lie
            rows = []
            for n in GATHER_CROSSOVER:
                idx = torch.from_numpy(
                    rng.integers(0, R, n, dtype=np.int32)).to(dev)
                want = int(gather_rows_sum_plain(table, idx))
                for kernel in ("ring", "direct"):
                    if int(bare(idx, kernel)) != want:
                        raise AssertionError(
                            f"gather {kernel} kernel != plain at N = {n}")
                r1 = device_ms(lambda: bare(idx, "ring"), DEVICE, reps=20)
                d1 = device_ms(lambda: bare(idx, "direct"), DEVICE, reps=20)
                rows.append(
                    f"N = {n}: ring {r1:.4f} / "
                    f"{stream_ms(lambda: bare(idx, 'ring'), n=20):.4f}, "
                    f"direct {d1:.4f} / "
                    f"{stream_ms(lambda: bare(idx, 'direct'), n=20):.4f}, "
                    f"launched: {'ring' if uses_ring(n, W) else 'direct'}")
            log("kernel", f"gather, both kernels at R = {R}, W = {W} (ms, "
                          f"one call between CUDA events / a launch in a "
                          f"stream of 20; a zeroing of the output word is "
                          f"in each): " + "; ".join(rows))
    return timing, max_err


def phase_bench(card: str):
    """The gather-rate bench at full size: the row-gather kernel's main
    path. Returns (rates dict, kernel launches)."""
    from vargeno_tpu_torch.kernels.gather import gather_rows_sum
    from vargeno_tpu_torch.tools.bench_gather import bench

    gather_rows_sum.launches = 0
    t0 = time.perf_counter()
    rates = bench(DEVICE, verbose=False)
    launches = gather_rows_sum.launches
    if launches <= 0:
        raise AssertionError("bench: the gather kernel was never launched")
    missing = [k for k in ("word_gather_1048576", "row_gather_1048576",
                           "row_gather_512B", "kernel_row_gather",
                           "kernel_row_gather_4194304",
                           "kernel_row_gather_512B", "device_sort_u32",
                           "scatter_rows", "scatter_scalar")
               if k not in rates]
    if missing:
        raise AssertionError(f"bench: missing rates {missing}")
    log("bench", f"[{card}] {json.dumps(rates)}")
    log("bench", f"{time.perf_counter() - t0:.2f} s, gather kernel launches "
                 f"{launches}")
    return rates, launches


# ----------------------------------------------------------------------
def build_or_load_index(fa, vcf, prefix, tag):
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.index.build import build_index

    if store.exists(prefix):
        log(tag, "index found in the cache")
        return None
    t0 = time.perf_counter()
    build_index(fa, vcf, prefix)
    dt = time.perf_counter() - t0
    log(tag, f"index build {dt:.2f} s")
    return dt


def check_no_overflow(runner, tag):
    bad = {k: v for k, v in runner.stats_totals.items()
           if "overflow" in k and v}
    if bad:
        raise AssertionError(f"{tag}: overflow counters left: {bad}")


def phase_golden():
    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.engine.cohort import CohortRunner
    from vargeno_tpu_torch.engine.device_index import build_device_index
    from vargeno_tpu_torch.engine.geno import GenoRunner
    from vargeno_tpu_torch.index import filt, store
    from vargeno_tpu_torch.io.fastq import autosize_shapes
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn

    d = os.path.join(CACHE, "mini")
    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, "mini")
    fq, vcf_in = os.path.join(FIX, "reads.fq"), os.path.join(FIX, "snps.vcf")
    build_or_load_index(os.path.join(FIX, "genome.fa"), vcf_in, prefix,
                        "golden")
    index = store.load(prefix)
    base = GenoConfig(batch_reads=512, max_read_len=128,
                      max_kmers_per_read=4)
    dix = build_device_index(index, DEVICE, base.ht_target_load)
    out = os.path.join(d, "out.vcf")

    def read(name):
        with open(os.path.join(FIX, name)) as f:
            return f.read()

    def check(tag, runner, launches, dt, golden, vcf_path=out):
        with open(vcf_path) as f:
            if f.read() != golden:
                raise AssertionError(f"mini VCF ({tag}) differs from golden")
        check_no_overflow(runner, f"golden/{tag}")
        if DEVICE == "cuda" and launches <= 0:
            raise AssertionError(f"golden/{tag} never launched the vote "
                                 f"kernel")
        log("golden", f"{tag}: VCF byte-identical to golden; "
                      f"{runner.n_reads} reads in {dt:.2f} s, vote launches "
                      f"{launches}, escalations {runner.n_escalations}")

    def run(tag, cfg, golden, index=index, dix=dix, reads=fq, **runner_kw):
        runner = GenoRunner(index, cfg, device=DEVICE, dix=dix, **runner_kw)
        before = vote_fn.launches
        t0 = time.perf_counter()
        runner.consume_fastq(reads)
        runner.write_vcf(vcf_in, out)
        check(tag, runner, vote_fn.launches - before,
              time.perf_counter() - t0, golden)
        return runner

    golden = read("golden_output.vcf")
    run("default caps", base, golden)
    run("E=640 C=1024", dataclasses.replace(
        base, events_per_read=640, candidates_per_read=1024), golden)
    run("dual, non-queued", base, golden, queued_orientation=False)
    tuned = run("auto-tune", dataclasses.replace(
        base, auto_tune=True, tune_batches=3), golden)
    if not tuned._cfg_run.events_per_read < base.events_per_read:
        raise AssertionError("golden: auto-tune did not fire")
    log("golden", f"auto-tune fired: E {base.events_per_read} -> "
                  f"{tuned._cfg_run.events_per_read}")

    # long reads (101 to 992 bases) at the shapes the CLI picks from a
    # FASTQ peek
    long_fq = os.path.join(FIX, "reads_long.fq")
    L, K = autosize_shapes(long_fq)
    run(f"long reads, auto-sized (L, K) = {(L, K)}", dataclasses.replace(
        base, max_read_len=L, max_kmers_per_read=K),
        read("golden_long_output.vcf"), reads=long_fq)

    # stop after 8 batches with a checkpoint every 4; a second runner resumes
    ck = os.path.join(d, "ckpt")
    for ext in (".npz", ".json"):
        if os.path.exists(ck + ext):
            os.remove(ck + ext)
    first = GenoRunner(index, base, device=DEVICE, dix=dix)
    first.consume_fastq(fq, limit_batches=8, checkpoint_path=ck,
                        checkpoint_every=4)
    if not 0 < first.n_reads < 20000:
        raise AssertionError(f"golden: the stopped run read "
                             f"{first.n_reads} reads")
    second = GenoRunner(index, base, device=DEVICE, dix=dix)
    before = vote_fn.launches
    t0 = time.perf_counter()
    second.consume_fastq(fq, checkpoint_path=ck)
    second.write_vcf(vcf_in, out)
    check(f"checkpoint at {first.n_reads} reads, resumed", second,
          vote_fn.launches - before, time.perf_counter() - t0, golden)

    # two-sample cohort: the second sample stops after 2 batches
    cohort = CohortRunner(index, ["full", "part"], base, device=DEVICE)
    before = vote_fn.launches
    t0 = time.perf_counter()
    cohort.consume_sample("full", fq)
    cohort.consume_sample("part", fq, limit_batches=2)
    outs = cohort.write_vcfs(vcf_in, os.path.join(d, "cohort_{sample}.vcf"))
    check("cohort sample 1 of 2", cohort._runner,
          vote_fn.launches - before, time.perf_counter() - t0, golden,
          vcf_path=outs[0])
    with open(outs[1]) as f:
        if f.read() == golden:
            raise AssertionError("golden: the 2-batch cohort sample equals "
                                 "the full one")

    # the filt index, saved under its own prefix (its derived tables must
    # not land in the unfiltered index's cache)
    fprefix = os.path.join(d, "mini_filt")
    if not store.exists(fprefix):
        filt.filt_prefix(prefix, fprefix)
    findex = store.load(fprefix)
    run("filt index", base, read("golden_filt_output.vcf"), index=findex,
        dix=build_device_index(findex, DEVICE, base.ht_target_load))


def phase_mesh():
    """Both mesh runners on the mini fixture: D = 1 (``make_mesh(1)``) and
    D = 2 (cuda:0 named twice: a check of the routing and the lockstep on
    one card, not a deployment), the routed one also from a route_factor
    of 0.05 (it must escalate), cohort on D = 2, and a single-device
    checkpoint resumed on the D = 2 sharded-dictionary runner. Each VCF
    must be byte-identical to golden, with no overflow left and the vote
    kernel launched (its count set to 0 just before each run and read just
    after)."""
    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import ShardedGenoRunner, make_mesh
    from vargeno_tpu_torch.engine.cohort import CohortRunner
    from vargeno_tpu_torch.engine.geno import GenoRunner
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn

    d = os.path.join(CACHE, "mini")
    index = store.load(os.path.join(d, "mini"))
    fq, vcf_in = os.path.join(FIX, "reads.fq"), os.path.join(FIX, "snps.vcf")
    with open(os.path.join(FIX, "golden_output.vcf")) as f:
        golden = f.read()
    base = GenoConfig(batch_reads=512, max_read_len=128,
                      max_kmers_per_read=4)
    out = os.path.join(d, "mesh.vcf")

    def mesh_of(D):
        return make_mesh(1) if D == 1 else make_mesh(devices=["cuda:0"] * D)

    def finish(tag, runner, t0, vcf_path=out):
        launches = vote_fn.launches
        with open(vcf_path) as f:
            if f.read() != golden:
                raise AssertionError(f"mesh/{tag}: VCF differs from golden")
        check_no_overflow(runner, f"mesh/{tag}")
        if launches <= 0:
            raise AssertionError(f"mesh/{tag}: the vote kernel was never "
                                 f"launched")
        log("mesh", f"{tag}: VCF byte-identical to golden; {runner.n_reads} "
                    f"reads in {time.perf_counter() - t0:.2f} s, vote "
                    f"launches {launches}, escalations "
                    f"{runner.n_escalations}, route_overflow "
                    f"{runner.stats_totals.get('route_overflow', 'n/a')}")
        return runner

    def run(tag, cls, D, cfg=base):
        runner = cls(index, mesh_of(D), cfg)
        vote_fn.launches = 0
        t0 = time.perf_counter()
        runner.consume_fastq(fq)
        runner.write_vcf(vcf_in, out)
        return finish(tag, runner, t0)

    for D in (1, 2):
        run(f"replicated index, D = {D}", ShardedGenoRunner, D)
        run(f"sharded dictionary, D = {D}", ShardedDictGenoRunner, D)
    tiny = run("sharded dictionary, D = 2, route_factor 0.05",
               ShardedDictGenoRunner, 2,
               dataclasses.replace(base, route_factor=0.05,
                                   auto_retry_max=8))
    if not (tiny.n_escalations > 0 and tiny._cfg_run.route_factor > 0.05):
        raise AssertionError("mesh: route_factor 0.05 did not escalate")

    cohort = CohortRunner(index, ["full"], base, mesh=mesh_of(2))
    vote_fn.launches = 0
    t0 = time.perf_counter()
    cohort.consume_sample("full", fq)
    outs = cohort.write_vcfs(vcf_in, os.path.join(d, "mesh_{sample}.vcf"))
    finish("cohort on D = 2", cohort._runner, t0, vcf_path=outs[0])

    ck = os.path.join(d, "mesh_ckpt")
    for ext in (".npz", ".json"):
        if os.path.exists(ck + ext):
            os.remove(ck + ext)
    first = GenoRunner(index, base, device=DEVICE)
    first.consume_fastq(fq, limit_batches=8, checkpoint_path=ck,
                        checkpoint_every=4)
    resumed = ShardedDictGenoRunner(index, mesh_of(2), base)
    vote_fn.launches = 0
    t0 = time.perf_counter()
    resumed.consume_fastq(fq, checkpoint_path=ck)
    resumed.write_vcf(vcf_in, out)
    finish(f"single-device checkpoint at {first.n_reads} reads, resumed "
           f"on the sharded dictionary at D = 2", resumed, t0)


def make_dataset(d):
    import numpy as np

    from vargeno_tpu_torch.testing import synth_genome, write_inputs

    fa, vcf, fq = (os.path.join(d, n)
                   for n in ("genome.fa", "snps.vcf", "reads.fq"))
    marker = os.path.join(d, "ready")
    if not os.path.exists(marker):
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        genome = synth_genome(rng, sizes=(GENOME_MB * 1_000_000,),
                              names=("chrB1",))
        write_inputs(d, rng, genome, n_snps=N_SNPS, n_reads=N_READS,
                     read_len=READ_LEN, err_frac=ERR_FRAC)
        with open(marker, "w") as f:
            f.write("ok")
        log("real", f"dataset written in {time.perf_counter() - t0:.2f} s")
    return fa, vcf, fq


def prepare_real() -> int:
    """The real phase's dataset and index, made in a process of its own
    (``start_real_prep``) beside the phases that time no reads/s; prints
    one JSON line ``{"real_prep": ...}``: the seconds of each, null where
    the cache already held it."""
    import vargeno_tpu_torch.testing  # noqa: F401 - not in the seconds

    d, prefix = real_paths()
    os.makedirs(d, exist_ok=True)
    fresh = not os.path.exists(os.path.join(d, "ready"))
    t0 = time.perf_counter()
    fa, vcf, _ = make_dataset(d)
    dataset_s = time.perf_counter() - t0 if fresh else None
    build_s = build_or_load_index(fa, vcf, prefix, "real")
    print(json.dumps({"real_prep": dict(dataset_s=dataset_s,
                                        build_s=build_s)}), flush=True)
    return 0


def start_session(cmd):
    """``cmd`` from the checkout's root in a session of its own (so that
    ``finish_tool`` can stop all it starts), its output piped."""
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def start_real_prep():
    return start_session([sys.executable, "-c", "import sys, chip_smoke; "
                          "sys.exit(chip_smoke.prepare_real())"])


def real_paths():
    """The real phase's cache directory and index prefix."""
    d = os.path.join(CACHE, f"bench{GENOME_MB}mb_{N_SNPS}snp_{N_READS}r_"
                            f"e{ERR_FRAC}_s{SEED}")
    return d, os.path.join(d, "idx")


def inside_checkout(path: str) -> str:
    """``path`` made absolute; it must lie inside this checkout."""
    real = os.path.realpath(path)
    if os.path.commonpath([real, os.path.realpath(ROOT)]) \
            != os.path.realpath(ROOT):
        raise SystemExit(f"error: {path} is not inside {ROOT}")
    return real


def step_ops_of(pkg_root: str, routed: bool = False) -> int:
    """``--step-ops-of DIR``: profile one forward step (single orientation,
    default capacities, the workload's first batch, after one warm-up step)
    of the package in the checkout DIR, on this checkout's cached workload
    and index, and print one JSON line: the step's device operations, the
    microseconds of the one named ``vote_kernel`` and of all of them (null
    where the profiler did not keep the records); and, at the timed shapes'
    random streams, the (E, B) entry's time between CUDA events round one
    call and the vote kernel's own time inside it. Run in a process of its
    own: a profiler trace taken late in a long process loses device
    records. ``--routed-step-ops-of DIR``: the same forward step through the
    sharded-dictionary runner at D = 1 (routed backend, sorted search), the
    step's operations and times only."""
    sys.path.insert(0, inside_checkout(pkg_root))
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.engine.device_index import build_device_index
    from vargeno_tpu_torch.engine.geno import GenoRunner, _encoder
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes, iter_read_batches
    from vargeno_tpu_torch.kernels import vote
    from vargeno_tpu_torch.utils.profiling import device_ms

    d, prefix = real_paths()
    fq = os.path.join(d, "reads.fq")
    L, K = autosize_shapes(fq)
    index = store.load(prefix)
    cfg = GenoConfig(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
                     ht_target_load=HT_LOAD)
    b = next(iter(iter_read_batches(fq, BATCH, L, K)))
    enc = _encoder(K)(b.codes, b.n_kmers)
    if routed:
        from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
        from vargeno_tpu_torch.dist.sharding import make_mesh

        r = ShardedDictGenoRunner(index, make_mesh(1), cfg)
        args = r._upload(enc, b.qual)[0]
        proc = r._proc(cfg)[0]
        counts = (r.ref_cnt[0], r.alt_cnt[0])
    else:
        r = GenoRunner(index, cfg, device=DEVICE,
                       dix=build_device_index(index, DEVICE, HT_LOAD))
        args = r._upload(enc, b.qual)
        proc = r._proc(cfg)
        counts = (r.ref_cnt, r.alt_cnt)

    def step():
        return proc.single_enc(*args, *counts)
    step()
    torch.cuda.synchronize()
    n, records = device_ops(step)
    vote_us = [us for name, us in records if "vote_kernel" in name]
    out = {"step_ops": n, "vote_kernel_us": vote_us[-1] if vote_us else None,
           # both calls of the trace on record: the second one's time
           "busy_us": (sum(us for _, us in records[n:])
                       if len(records) == 2 * n else None),
           "eb_vote_kernel_us": {}, "eb_entry_ms": {}}
    # the (E, B) entry, which every checkout has, on the random streams
    for E, B, C in ([] if routed else VOTE_TIMED):
        quartet, ev_n, _ = random_events(E, B, C, seed=E * 1000 + C)

        def entry():
            return vote.vote_scan(*quartet, C, ev_n)
        out["eb_entry_ms"][str((E, B, C))] = device_ms(entry, DEVICE,
                                                       reps=20)
        out["eb_vote_kernel_us"][str((E, B, C))] = kernel_us(entry,
                                                             "vote_kernel")
    print(json.dumps(out), flush=True)
    return 0


def profiled_step(pkg_root: str, routed: bool = False) -> dict:
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--routed-step-ops-of" if routed else "--step-ops-of",
                        pkg_root],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"profiling the step of {pkg_root} failed:\n"
                           + r.stderr[-2000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


def phase_real(card: str, gather_rates: dict, parent: str | None,
               prep: dict):
    import numpy as np
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.engine.device_index import build_device_index
    from vargeno_tpu_torch.engine.geno import GenoRunner, _encoder
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes, iter_read_batches
    from vargeno_tpu_torch.kernels.vote import (NB_FLAG, VALID_FLAG,
                                                vote_scan,
                                                vote_scan_records,
                                                vote_scan_records_plain)
    from vargeno_tpu_torch.utils.roofline import roofline

    # the dataset and index come from prepare_real (``prep``: seconds)
    d, prefix = real_paths()
    vcf, fq = os.path.join(d, "snps.vcf"), os.path.join(d, "reads.fq")
    build_s = prep["build_s"]

    L, K = autosize_shapes(fq)
    cfg = GenoConfig(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
                     ht_target_load=HT_LOAD)
    on_cuda = DEVICE == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = store.load(prefix)
    dix = build_device_index(index, DEVICE, HT_LOAD)
    if on_cuda:
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log("real", f"index load + device tables {load_s:.2f} s, "
                f"{dix.nbytes()} bytes on {DEVICE} (both_ht "
                f"{dix.both_ht.numel() * 4} B, chain {dix.both_ht_chain})")

    # the main path: launch counts are reset just before and read just after
    runner = GenoRunner(index, cfg, device=DEVICE, dix=dix)
    vote_scan_records.launches = vote_scan.launches = 0
    t0 = time.perf_counter()
    runner.consume_fastq(fq)
    if on_cuda:
        torch.cuda.synchronize()
    geno_s = time.perf_counter() - t0
    launches = vote_scan_records.launches
    if vote_scan.launches:
        raise AssertionError("real: the step went through the (E, B) entry")
    rate = runner.n_reads / geno_s
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    st = runner.stats_totals
    check_no_overflow(runner, "real")
    rc, ac = runner.host_counts()
    if rc.shape != (dix.n_sites + 1,) or int(rc.sum() + ac.sum()) <= 0:
        raise AssertionError("real: empty or misshapen pileup counts")
    if st["n_processed"] < 0.5 * runner.n_reads:
        raise AssertionError(f"real: only {st['n_processed']} of "
                             f"{runner.n_reads} reads processed")
    out = os.path.join(d, "out.vcf")
    runner.write_vcf(vcf, out)
    with open(out) as f:
        n_calls = sum(1 for line in f if not line.startswith("#"))
    if n_calls <= 0:
        raise AssertionError("real: no genotype calls written")
    if on_cuda and launches <= 0:
        raise AssertionError("real: the vote kernel was never launched")
    log("real", f"[{card}] geno {runner.n_reads} reads in {geno_s:.3f} s = "
                f"{rate:.1f} reads/s (index load excluded); peak device "
                f"memory {peak} B; n_processed {st['n_processed']}, retry "
                f"reads {runner.n_retry_reads}, escalations "
                f"{runner.n_escalations}, vote launches {launches}, calls "
                f"{n_calls}, final caps "
                f"E={runner._cfg_run.events_per_read} "
                f"C={runner._cfg_run.candidates_per_read}")

    # roofline of that pass: its reads/s and measured retry fraction, the
    # escalated config it ended on, and the bench phase's measured rates
    report = roofline(runner._cfg_run, dix, torch.cuda.get_device_name(0)
                      if on_cuda else "cpu", BATCH, rate,
                      retry_frac=runner.n_retry_reads / runner.n_reads,
                      gather_rates=gather_rates)
    log("real", f"[{card}] roofline {json.dumps(report)}")

    # a second pass in this process with auto-tune on: equal counts, and
    # both rates side by side (one pass each: no ranking is claimed)
    tuned = GenoRunner(index, dataclasses.replace(cfg, auto_tune=True),
                       device=DEVICE, dix=dix)
    t0 = time.perf_counter()
    tuned.consume_fastq(fq)
    if on_cuda:
        torch.cuda.synchronize()
    tuned_rate = tuned.n_reads / (time.perf_counter() - t0)
    check_no_overflow(tuned, "real/auto-tune")
    t_rc, t_ac = tuned.host_counts()
    if not (np.array_equal(t_rc, rc) and np.array_equal(t_ac, ac)):
        raise AssertionError("real: the auto-tuned pass counts differently")
    tc = tuned._cfg_run
    if tc == cfg:
        raise AssertionError("real: auto-tune did not fire")
    log("real", f"[{card}] auto-tune pass {tuned_rate:.1f} reads/s against "
                f"{rate:.1f} untuned (one pass each), equal counts; "
                f"escalations {tuned.n_escalations}; tuned caps "
                f"E={tc.events_per_read} C={tc.candidates_per_read} "
                f"neighbor_item_frac={tc.neighbor_item_frac:.5f} "
                f"probe_hit_cap={tc.probe_hit_cap} "
                f"probe_active_frac={tc.probe_active_frac:.5f} "
                f"scan_active_frac={tc.scan_active_frac:.5f} "
                f"agree_cap={tc.agree_cap}")

    # cross-check: the first two batches, kernel vote vs plain vote; the
    # first forward batch's own records are kept for the timing below
    encode = _encoder(K)
    batches = []
    for b in iter_read_batches(fq, BATCH, L, K):
        batches.append((encode(b.codes, b.n_kmers), b.qual))
        if len(batches) == 2:
            break
    kept = []

    def keeping_vote(ev_idx, ev_meta, ev_total, C):
        if not kept:
            kept.append(((ev_idx, ev_meta, ev_total), C))
        return vote_scan_records(ev_idx, ev_meta, ev_total, C)

    outs = []
    for hook in (keeping_vote, vote_scan_records_plain):
        r = GenoRunner(index, runner._cfg_run, device=DEVICE, dix=dix,
                       vote=hook)
        masks = [r.run_batch(enc, q) for enc, q in batches]
        outs.append((r.host_counts(), masks))
    (k_rc, k_ac), k_masks = outs[0]
    (p_rc, p_ac), p_masks = outs[1]
    same = (np.array_equal(k_rc, p_rc) and np.array_equal(k_ac, p_ac)
            and all(np.array_equal(a, b) for ma, mb in zip(k_masks, p_masks)
                    for a, b in zip(ma, mb)))
    if not same:
        raise AssertionError("real: kernel and plain vote disagree on the "
                             "first two batches")
    log("real", f"first two batches: kernel and plain vote give equal "
                f"counts ({int(k_rc.sum())} ref, {int(k_ac.sum())} alt)")

    # the bare launch on the first forward batch's records (real reads,
    # real event counts)
    records, C = kept[0]
    B, E = records[0].shape
    real_raw_ms = time_vote_on_step("real", card, records, C)["raw_ms"]

    # device operations of one vote call: through the records entry, and
    # through the (E, B) entry the way the step fed it before (unpacked
    # and transposed views)
    def eb_call():
        ev_idx, meta, total = records
        return vote_scan(ev_idx.t(), (meta & 0x1F).t(),
                         ((meta & NB_FLAG) != 0).t(),
                         ((meta & VALID_FLAG) != 0).t(), C,
                         ev_n=total.clamp(max=E))
    vote_ops = count_device_ops(lambda: vote_scan_records(*records, C))
    eb_ops = count_device_ops(eb_call)
    if vote_ops > 3:
        raise AssertionError(f"real: a vote call is {vote_ops} device "
                             f"operations, more than 3")
    log("real", f"device operations of one vote call (torch.profiler): "
                f"{vote_ops} through the records entry, {eb_ops} through "
                f"the (E, B) entry on unpacked, transposed views")

    # one forward step of this checkout, and of the --parent checkout,
    # each profiled in a process of its own
    mine = profiled_step(ROOT)
    theirs = profiled_step(parent) if parent else None

    def told(got):
        return (f"{got['step_ops']} device operations, "
                f"{got['busy_us']} us on the card in all, vote kernel "
                f"{got['vote_kernel_us']} us")
    log("real", f"[{card}] one forward step (torch.profiler): {told(mine)}; "
                f"the same step of the parent checkout: "
                f"{told(theirs) if theirs else 'not run (no --parent)'}")
    for key, what in (("eb_vote_kernel_us", "vote kernel's own time (us, "
                       "torch.profiler)"),
                      ("eb_entry_ms", "(E, B) vote entry (ms between CUDA "
                       "events round one call)")):
        log("real", f"[{card}] {what} on the kernel phase's random streams: "
                    f"{json.dumps(mine[key])}; the parent checkout's: "
                    + (json.dumps(theirs[key]) if theirs
                       else "not run (no --parent)"))
    return dict(counts=(rc, ac), dix_bytes=dix.nbytes(),
                build_s=build_s, load_s=load_s, rate=rate,
                tuned_rate=tuned_rate, peak=peak, launches=launches,
                roofline=report, real_raw_ms=real_raw_ms,
                real_kernel_us=mine["vote_kernel_us"],
                kernel_us=mine["eb_vote_kernel_us"], parent=theirs,
                vote_call_ops=vote_ops, step_ops=mine["step_ops"])


def phase_routed(card: str, ht: dict) -> dict:
    """The 48 Mb workload through the sharded-dictionary runner, untuned, at
    D = 1 and D = 2 (cuda:0 named twice: a check, not a deployment), after
    the hash-table passes have freed their index: counts equal to the
    hash-table runner's, no overflow left, the vote kernel launched (count
    set to 0 just before each pass, read just after); reads/s,
    escalations, route_overflow, peak device memory (reset before each
    pass) and the index's device bytes beside the hash-table runner's. Then
    the device operations of one routed forward step, and the oracle spot
    check: the first 2,048 reads through the sequential oracle and through
    the D = 1 runner, every one of the 500,000 sites' counts equal."""
    import numpy as np
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import make_mesh
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes
    from vargeno_tpu_torch.kernels.vote import vote_scan_records
    from vargeno_tpu_torch.oracle import OracleEngine

    gc.collect()   # the hash-table passes' index, before peaks are taken
    d, prefix = real_paths()
    fq = os.path.join(d, "reads.fq")
    L, K = autosize_shapes(fq)
    cfg = GenoConfig(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
                     ht_target_load=HT_LOAD)
    index = store.load(prefix)
    ht_rc, ht_ac = ht["counts"]
    out = {}
    for D in (1, 2):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mesh = make_mesh(1) if D == 1 else make_mesh(devices=["cuda:0"] * D)
        runner = ShardedDictGenoRunner(index, mesh, cfg)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        vote_scan_records.launches = 0
        t0 = time.perf_counter()
        runner.consume_fastq(fq)
        torch.cuda.synchronize()
        geno_s = time.perf_counter() - t0
        launches = vote_scan_records.launches
        peak = torch.cuda.max_memory_allocated()
        check_no_overflow(runner, f"routed/D={D}")
        rc, ac = runner.host_counts()
        if not (np.array_equal(rc, ht_rc) and np.array_equal(ac, ht_ac)):
            raise AssertionError(f"routed/D={D}: counts differ from the "
                                 f"hash-table runner's")
        if launches <= 0:
            raise AssertionError(f"routed/D={D}: the vote kernel was never "
                                 f"launched")
        shard = runner.shards[0]
        row_b = (shard.ref_key.element_size()
                 + 2 * shard.dix.ref_meta.element_size())
        nbytes = runner.device_bytes()
        st = runner.stats_totals
        out[f"D{D}"] = dict(
            reads_s=runner.n_reads / geno_s, geno_s=geno_s, setup_s=setup_s,
            escalations=runner.n_escalations,
            route_overflow=st["route_overflow"],
            final_route_factor=runner._cfg_run.route_factor,
            retry_reads=runner.n_retry_reads, vote_launches=launches,
            peak_bytes=peak, index_bytes=nbytes, ref_row_bytes=row_b)
        what = " (cuda:0 twice: a check, not a deployment)" if D > 1 else ""
        log("real", f"[{card}] sharded dictionary, D = {D}{what}"
                    f": {runner.n_reads} reads in {geno_s:.3f} s = "
                    f"{runner.n_reads / geno_s:.1f} reads/s (partition + "
                    f"upload {setup_s:.2f} s excluded); counts equal to the "
                    f"hash-table runner's; escalations {runner.n_escalations}"
                    f" (route_factor {cfg.route_factor} -> "
                    f"{runner._cfg_run.route_factor}), route_overflow left "
                    f"{st['route_overflow']}, "
                    f"retry reads {runner.n_retry_reads}, vote launches "
                    f"{launches}; peak device memory {peak} B; index "
                    f"{nbytes} B on the card against the hash-table "
                    f"runner's {ht['dix_bytes']} B; {row_b} B a ref row "
                    f"(int64 key + meta)")
        del runner, mesh, shard   # before the next pass's peak is taken
    torch.cuda.empty_cache()

    routed = profiled_step(ROOT, routed=True)
    log("real", f"[{card}] one routed forward step at D = 1 "
                f"(torch.profiler): {routed['step_ops']} device operations, "
                f"{routed['busy_us']} us on the card in all, vote kernel "
                f"{routed['vote_kernel_us']} us; the hash-table step: "
                f"{ht['step_ops']} operations")
    out["routed_step"] = routed

    # oracle spot check on the first 2,048 reads
    head = os.path.join(d, "head2048.fq")
    with open(fq) as f, open(head, "w") as g:
        for i, line in enumerate(f):
            if i >= 4 * 2048:
                break
            g.write(line)
    t0 = time.perf_counter()
    eng = OracleEngine(index)
    eng.run_fastq(head)
    oracle_s = time.perf_counter() - t0
    runner = ShardedDictGenoRunner(index, make_mesh(1),
                                   dataclasses.replace(cfg, batch_reads=2048))
    runner.consume_fastq(head)
    check_no_overflow(runner, "oracle spot check")
    rc, ac = runner.host_counts()
    s = index.sites
    n = s.pos.shape[0]
    want_r = np.array([eng.pileup[int(p)][4] for p in s.pos])
    want_a = np.array([eng.pileup[int(p)][5] for p in s.pos])
    bad = int((np.minimum(rc[:n], cfg.max_cov) != want_r).sum()
              + (np.minimum(ac[:n], cfg.max_cov) != want_a).sum())
    if bad or int(want_r.sum() + want_a.sum()) <= 0:
        raise AssertionError(f"oracle spot check: {bad} count mismatches "
                             f"over {n} sites (or no counts)")
    log("real", f"oracle spot check: {runner.n_reads} reads, 0 count "
                f"mismatches over {n} sites ({int(want_r.sum())} ref and "
                f"{int(want_a.sum())} alt counts; oracle {oracle_s:.2f} s)")
    out["oracle"] = dict(reads=runner.n_reads, sites=n, mismatches=bad,
                         oracle_s=oracle_s)
    del runner
    return out


def mh_worker(spec: dict) -> int:
    """``--mh-worker SPEC``: one process of a multi-process cluster. Joins
    the group (``spec``: port, world, rank, backend, devices), loads the
    index once, and for each run in ``spec["runs"]`` builds the
    multi-process runner, drives ``consume_fastq`` (the vote kernel's
    count set to 0 just before, read just after; the processes start it
    together after a barrier) and ``write_vcf``, and prints one JSON line
    ``{"mh_run": ...}`` with what this process saw. A run with a
    ``counts`` path also has process 0 save the merged per-site counts
    there (``np.savez``: ref, alt)."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist import multihost
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn

    cluster = multihost.initialize(f"tcp://localhost:{spec['port']}",
                                   spec["world"], spec["rank"],
                                   spec["backend"], timeout=spec["timeout"])
    mesh = multihost.ProcessMesh(cluster, spec["devices"])
    index = store.load(spec["prefix"])
    for run in spec["runs"]:
        cls = (multihost.MultiHostDictGenoRunner if run["dict"]
               else multihost.MultiHostGenoRunner)
        cfg = GenoConfig(**{**spec["config"], **run.get("cfg", {})})
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(mesh.devices[0])
        t0 = time.perf_counter()
        runner = cls(index, mesh, cfg, queued_orientation=run["queued"])
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        pass_s = []
        for k in range(run.get("passes", 1)):
            multihost.barrier(cluster)
            vote_fn.launches = 0
            t0 = time.perf_counter()
            runner.consume_fastq(spec["fq"],
                                 checkpoint_path=run.get("checkpoint"),
                                 limit_batches=run.get("limit"))
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
            if k:
                continue   # a later pass is timed only (counts add up)
            got = dict(
                tag=run["tag"], rank=cluster.rank, world=cluster.size,
                backend=cluster.backend, shards=runner.D,
                reads=runner.n_reads, geno_s=pass_s[0], setup_s=setup_s,
                vote_launches=vote_fn.launches,
                escalations=runner.n_escalations,
                batches=runner.meter.batches,
                retry_batches=runner.n_retry_batches,
                retry_reads=runner.n_retry_reads,
                overflow={key: v for key, v in runner.stats_totals.items()
                          if "overflow" in key and v})
            if run.get("counts"):   # a collective: every process calls it
                rc, ac = runner.host_counts()
                if cluster.rank == 0:
                    np.savez(run["counts"], ref=rc, alt=ac)
            runner.write_vcf(spec["vcf_in"], run["out"])
        got.update(pass_s=pass_s, index_bytes=runner.device_bytes(),
                   peak_bytes=torch.cuda.max_memory_allocated(
                       mesh.devices[0]))
        print(json.dumps({"mh_run": got}), flush=True)
        del runner
    multihost.shutdown(cluster)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_cluster(name: str, backend: str, devices, common):
    """Start one worker process (a fresh interpreter) a rank, rank r on
    the devices ``devices[r]``; returns (name, processes)."""
    port = free_port()
    procs = []
    for rank, devs in enumerate(devices):
        spec = dict(common, port=port, world=len(devices), rank=rank,
                    backend=backend, devices=devs)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mh-worker",
             json.dumps(spec)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return name, procs


def finish_cluster(cluster, timeout: float) -> dict:
    """Wait for a cluster's processes (all killed once ``timeout`` has
    passed); any failed process fails the phase. Returns {tag: [the run's
    line of each rank]}."""
    name, procs = cluster
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"multihost/{name}: the cluster did not finish "
                           f"within {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"multihost/{name}: processes (rank, exit code) "
                           f"{bad} failed:\n" + "\n".join(
                               err[-3000:] for _, err in outs))
    runs: dict = {}
    for out, _ in outs:
        for line in out.splitlines():
            if line.startswith('{"mh_run"'):
                got = json.loads(line)["mh_run"]
                runs.setdefault(got["tag"], []).append(got)
    return runs


def phase_multihost(card: str, routed: dict) -> dict:
    """Multi-process geno (``dist/multihost.py``) in fresh interpreters,
    each cluster under its own time limit; a failed process fails the
    phase. (a) The mini fixture on 2 processes x 1 shard, both naming
    cuda:0, over gloo (NCCL takes one process a card): data-parallel
    queued, inline dual, sharded dictionary, forced escalation, and a
    run stopped after 3 batches with a checkpoint that a single-process
    runner of the port resumes. (b) The same runs on one process at world
    size 1 over nccl (the stopped run resumed on it). Each VCF is
    byte-identical to golden, with no overflow left and the vote kernel
    launched in every process. (c) The 48 Mb workload, untuned, through the
    multi-process sharded dictionary on 2 processes on cuda:0 over gloo:
    its VCF byte-identical to the single-process hash-table pass's, no
    overflow, the vote kernel launched in each process; reads/s, each
    process's peak device memory and index bytes on the card, escalations
    and retry against forward batches, beside the threaded D = 2 rate of
    the routed phase. Two processes on one card check the protocol and the
    memory of a shard; they are not a deployment."""
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.engine.geno import GenoRunner
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes

    gc.collect()
    torch.cuda.empty_cache()
    d = os.path.join(CACHE, "mini")
    prefix = os.path.join(d, "mini")
    fq, vcf_in = os.path.join(FIX, "reads.fq"), os.path.join(FIX, "snps.vcf")
    with open(os.path.join(FIX, "golden_output.vcf")) as f:
        golden = f.read()
    base = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
    tiny = dict(events_per_read=4, probe_hit_cap=2, agree_cap=1)

    def mini_runs(tag, ck, resume):
        for ext in (".npz", ".json"):
            if os.path.exists(ck + ext):
                os.remove(ck + ext)
        runs = [dict(tag="queued", dict=False, queued=True),
                dict(tag="inline dual", dict=False, queued=False),
                dict(tag="sharded dictionary", dict=True, queued=True),
                dict(tag="forced escalation", dict=False, queued=True,
                     cfg=tiny),
                dict(tag="stopped at 3 batches", dict=False, queued=True,
                     checkpoint=ck, limit=3)]
        if resume:
            runs.append(dict(tag="resumed", dict=False, queued=True,
                             checkpoint=ck))
        for r in runs:
            r["out"] = os.path.join(d, f"mh_{tag}_{r['tag'].replace(' ', '_')}"
                                       f".vcf")
        return dict(prefix=prefix, fq=fq, vcf_in=vcf_in, config=base,
                    timeout=300, runs=runs)

    def check(name, runs, spec, world):
        for run in spec["runs"]:
            got = runs.get(run["tag"], [])
            if len(got) != world:
                raise AssertionError(f"multihost/{name}/{run['tag']}: "
                                     f"{len(got)} of {world} processes "
                                     f"reported")
            with open(run["out"]) as f:
                same = f.read() == golden
            if same == (run.get("limit") is not None):
                raise AssertionError(f"multihost/{name}/{run['tag']}: VCF "
                                     + ("equals" if same else "differs from")
                                     + " golden")
            for g in got:
                if g["overflow"] or g["vote_launches"] <= 0:
                    raise AssertionError(f"multihost/{name}/{run['tag']}: "
                                         f"rank {g['rank']}: {g}")
            if run["tag"] == "forced escalation" and not all(
                    g["escalations"] > 0 for g in got):
                raise AssertionError(f"multihost/{name}: the tiny caps did "
                                     f"not escalate")
            log("multihost", f"{name}, {run['tag']}: "
                + ("VCF byte-identical to golden" if same else
                   f"stopped at {got[0]['reads']} reads")
                + f"; vote launches per process "
                f"{[g['vote_launches'] for g in got]}, escalations "
                f"{got[0]['escalations']}, batches {got[0]['batches']} "
                f"({got[0]['retry_batches']} lockstep retry)")

    t0 = time.perf_counter()
    spec_a = mini_runs("gloo2", os.path.join(d, "mh_ck_a"), resume=False)
    spec_b = mini_runs("nccl1", os.path.join(d, "mh_ck_b"), resume=True)
    a = start_cluster("2 processes on cuda:0 over gloo", "gloo",
                      [["cuda:0"]] * 2, spec_a)
    b = start_cluster("1 process over nccl", "nccl", [["cuda:0"]], spec_b)
    runs_a, runs_b = finish_cluster(a, 600), finish_cluster(b, 600)
    check(a[0], runs_a, spec_a, 2)
    check(b[0], runs_b, spec_b, 1)

    # the 2-process checkpoint, resumed by the single-process runner
    index = store.load(prefix)
    resumed = GenoRunner(index, GenoConfig(**base), device=DEVICE)
    resumed.consume_fastq(fq, checkpoint_path=os.path.join(d, "mh_ck_a"))
    out = os.path.join(d, "mh_resumed_single.vcf")
    resumed.write_vcf(vcf_in, out)
    with open(out) as f:
        if f.read() != golden:
            raise AssertionError("multihost: the single-process runner's "
                                 "resume of the 2-process checkpoint "
                                 "differs from golden")
    check_no_overflow(resumed, "multihost/resumed")
    del resumed, index
    log("multihost", f"the 2-process checkpoint resumed by a single-process "
                     f"runner: VCF byte-identical to golden; mini clusters "
                     f"{time.perf_counter() - t0:.1f} s")

    # (c) the 48 Mb workload, 2 processes on one card
    rd, rprefix = real_paths()
    rfq = os.path.join(rd, "reads.fq")
    L, K = autosize_shapes(rfq)
    out = os.path.join(rd, "mh_out.vcf")
    spec_c = dict(prefix=rprefix, fq=rfq, vcf_in=os.path.join(rd,
                                                              "snps.vcf"),
                  config=dict(batch_reads=BATCH, max_read_len=L,
                              max_kmers_per_read=K, ht_target_load=HT_LOAD),
                  timeout=300, runs=[dict(tag="48 Mb", dict=True,
                                          queued=True, out=out)])
    t0 = time.perf_counter()
    c = start_cluster("48 Mb, 2 processes on cuda:0 over gloo", "gloo",
                      [["cuda:0"]] * 2, spec_c)
    got = finish_cluster(c, 900).get("48 Mb", [])
    wall_s = time.perf_counter() - t0
    if len(got) != 2:
        raise AssertionError(f"multihost/48 Mb: {len(got)} of 2 processes "
                             f"reported")
    with open(out) as f, open(os.path.join(rd, "out.vcf")) as g:
        if f.read() != g.read():
            raise AssertionError("multihost/48 Mb: the 2-process VCF differs "
                                 "from the single-process hash-table "
                                 "pass's")
    for g in got:
        if g["overflow"] or g["vote_launches"] <= 0:
            raise AssertionError(f"multihost/48 Mb: rank {g['rank']}: {g}")
    geno_s = max(g["geno_s"] for g in got)
    reads = got[0]["reads"]
    fwd = got[0]["batches"] - got[0]["retry_batches"]
    d2 = routed["D2"]["reads_s"]
    log("multihost", f"[{card}] 48 Mb through the multi-process sharded "
                     f"dictionary, 2 processes x 1 shard on cuda:0 over gloo "
                     f"(a check of the protocol and a shard's memory, not a "
                     f"deployment): VCF byte-identical to the single-process "
                     f"hash-table pass's; {reads} reads in {geno_s:.3f} s = "
                     f"{reads / geno_s:.1f} reads/s (the slower process's "
                     f"consume_fastq; partition + upload excluded), against "
                     f"{d2:.1f} reads/s for the threaded D = 2 pass of the "
                     f"routed phase in this run; escalations "
                     f"{got[0]['escalations']}; {fwd} forward + "
                     f"{got[0]['retry_batches']} lockstep retry batches; per "
                     f"process: vote launches "
                     f"{[g['vote_launches'] for g in got]}, peak device "
                     f"memory {[g['peak_bytes'] for g in got]} B, index "
                     f"{[g['index_bytes'] for g in got]} B on the card, "
                     f"setup {[round(g['setup_s'], 2) for g in got]} s; "
                     f"cluster wall {wall_s:.1f} s")
    return dict(
        mini={"gloo_2x1": {t: [g["vote_launches"] for g in v]
                           for t, v in runs_a.items()},
              "nccl_1x1": {t: [g["vote_launches"] for g in v]
                           for t, v in runs_b.items()}},
        mb48=dict(reads_s=reads / geno_s, geno_s=geno_s,
                  threaded_d2_reads_s=d2, forward_batches=fwd,
                  retry_batches=got[0]["retry_batches"],
                  escalations=got[0]["escalations"],
                  vote_launches=[g["vote_launches"] for g in got],
                  peak_bytes=[g["peak_bytes"] for g in got],
                  index_bytes=[g["index_bytes"] for g in got],
                  setup_s=[g["setup_s"] for g in got]))


def start_fuzz_big(root: str):
    """Phase fuzz (e): ``python -m vargeno_tpu_torch.tools.fuzz_diff 1
    FUZZ_BIG_SEED`` at VGT_FUZZ_BIG=1 in a fresh interpreter, its fixture
    in a temporary directory under ``root``. The tool runs the seed's
    fork-parallel oracle before its process touches the card."""
    tmp = os.path.join(root, "big")
    os.makedirs(tmp)
    return subprocess.Popen(
        [sys.executable, "-m", "vargeno_tpu_torch.tools.fuzz_diff", "1",
         str(FUZZ_BIG_SEED), "--device", "cuda"], cwd=ROOT,
        env=dict(os.environ, VGT_FUZZ_BIG="1", TMPDIR=tmp),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_fuzz_big(proc, timeout: float) -> dict:
    """Wait for the big seed's tool run and read its seed line."""
    import re

    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"fuzz/big seed: the tool did not finish within "
                           f"{timeout} s") from None
    for line in out.splitlines():
        log("fuzz", f"big seed: {line}")
    m = re.search(rf"^seed {FUZZ_BIG_SEED}: (PASS|FAIL) \(([\d.]+)s "
                  r"engine\+oracle\) (.*) mismatches=(\d+) "
                  r"escalations=(\d+) vote_launches=(\d+) "
                  r"overflow_left=(.*)$", out, re.M)
    if proc.returncode or not m or m.group(1) != "PASS":
        raise AssertionError(f"fuzz/big seed {FUZZ_BIG_SEED}: the tool "
                             f"exited {proc.returncode}:\n{out[-3000:]}"
                             f"\n{err[-3000:]}")
    return dict(seed=FUZZ_BIG_SEED, case=m.group(3),
                mismatches=int(m.group(4)), escalations=int(m.group(5)),
                vote_launches=int(m.group(6)), overflow_left=m.group(7),
                engine_oracle_s=float(m.group(2)),
                waited_s=time.perf_counter() - t0)


def phase_fuzz(card: str) -> dict:
    """Differential fuzzing (``vargeno_tpu_torch/tools/fuzz_diff.py``) of
    every runner against the sequential oracle, seeds fixed in advance.
    (a) Seeds 0-23 (``FUZZ_SEEDS``), each through GenoRunner on the card
    as its draw says (queued or inline dual, its batch size and caps);
    (b) the same fixtures through the replicated-index mesh at D = 2 and
    (c) through the sharded dictionary at D = 1 and D = 2 (D = 2 names
    cuda:0 twice), each with the seed's own config; (d) seeds 0 and 1 on 2
    processes x 1 shard naming cuda:0 over gloo, replicated and sharded
    dictionary, each process loading the seed's index from the port's
    ``store.save``; (e) seed 0 at VGT_FUZZ_BIG scale through the tool's
    command line in a process of its own, beside (a)-(d). Every run's
    ``min(count, 63)`` must equal the oracle's at every site, with no
    overflow left after escalation and the vote kernel launched (its
    count set to 0 just before each run and read just after). All runs
    go through before a failure is raised, so that every mismatch shows."""
    import shutil

    import numpy as np
    import torch

    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import ShardedGenoRunner
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn
    from vargeno_tpu_torch.tools import fuzz_diff

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    root = os.path.join(CACHE, "fuzz")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    mesh_runner = fuzz_diff.mesh_runner
    runners = {"GenoRunner": fuzz_diff.geno_runner,
               "replicated mesh, D = 2": mesh_runner(ShardedGenoRunner, 2),
               "sharded dictionary, D = 1":
                   mesh_runner(ShardedDictGenoRunner, 1),
               "sharded dictionary, D = 2":
                   mesh_runner(ShardedDictGenoRunner, 2)}
    tally: dict = {}
    failures = []

    def count(name, seed, mismatches, escalations, launches, seconds,
              overflow):
        t = tally.setdefault(name, dict(seeds=0, mismatches=0,
                                        escalations=0, vote_launches=0,
                                        seconds=0.0))
        t["seeds"] += 1
        t["mismatches"] += mismatches
        t["escalations"] += escalations
        t["vote_launches"] += launches
        t["seconds"] += seconds
        if mismatches or overflow or launches <= 0:
            failures.append(f"{name}, seed {seed}: {mismatches} mismatches, "
                            f"overflow left {overflow}, vote launches "
                            f"{launches}")

    def start_mh(prep, d):
        prefix = os.path.join(d, "index")
        store.save(prefix, prep.index)
        runs = [dict(tag=tag, dict=is_dict, queued=prep.case["queued"],
                     out=os.path.join(d, f"mh_{i}.vcf"),
                     counts=os.path.join(d, f"mh_{i}.npz"))
                for i, (tag, is_dict) in enumerate(
                    (("replicated", False), ("sharded dictionary", True)))]
        spec = dict(prefix=prefix, fq=prep.fq, vcf_in=prep.vcf,
                    config=prep.case["config"], timeout=300, runs=runs)
        return spec, start_cluster(
            f"fuzz seed {prep.case['seed']}, 2 processes on cuda:0 over "
            f"gloo", "gloo", [["cuda:0"]] * 2, spec)

    def finish_mh(prep, spec, cluster):
        runs = finish_cluster(cluster, 600)
        for run in spec["runs"]:
            got = runs.get(run["tag"], [])
            name = f"2 processes x 1 shard, {run['tag']}"
            if len(got) != 2:
                raise AssertionError(f"fuzz/{name}: {len(got)} of 2 "
                                     f"processes reported")
            with np.load(run["counts"]) as z:
                bad = fuzz_diff.bad_sites(prep, z["ref"], z["alt"])
            launches = [g["vote_launches"] for g in got]
            log("fuzz", f"{name}: seed {prep.case['seed']}: "
                        f"{'PASS' if not bad else 'FAIL'} "
                        f"{fuzz_diff.describe(prep.case)} mismatches="
                        f"{len(bad)} escalations="
                        f"{got[0]['escalations']} vote launches per process "
                        f"{launches} overflow left "
                        f"{[g['overflow'] for g in got]}")
            for line in bad[:10]:
                log("fuzz", line)
            count(name, prep.case["seed"], len(bad), got[0]["escalations"],
                  min(launches), max(g["geno_s"] for g in got),
                  [g["overflow"] for g in got if g["overflow"]])

    big = start_fuzz_big(root)   # (e) runs beside (a)-(d)
    clusters = []
    try:
        for seed in FUZZ_SEEDS:
            d = os.path.join(root, f"seed{seed}")
            os.makedirs(d)
            prep = fuzz_diff.prepare(seed, d, big=False)
            if seed in FUZZ_MH_SEEDS:
                clusters.append((prep, *start_mh(prep, d)))
            for name, make in runners.items():
                vote_fn.launches = 0
                got = fuzz_diff.check(
                    prep, "cuda:0", make,
                    say=lambda m, name=name: log("fuzz", f"{name}: {m}"))
                count(name, seed, got["mismatches"], got["escalations"],
                      vote_fn.launches, got["engine_s"], got["overflow"])
        for prep, spec, cluster in clusters:
            finish_mh(prep, spec, cluster)
        big_got = finish_fuzz_big(big, 780)
    finally:   # on a failure, stop what still runs
        for p in [big] + [p for _, _, (_, procs) in clusters for p in procs]:
            if p.poll() is None:
                p.kill()
                p.wait()
    name = f"GenoRunner, big seed {FUZZ_BIG_SEED}"
    count(name, FUZZ_BIG_SEED, big_got["mismatches"],
          big_got["escalations"], big_got["vote_launches"],
          big_got["engine_oracle_s"],
          "" if big_got["overflow_left"] == "0" else
          big_got["overflow_left"])
    for name, t in tally.items():
        log("fuzz", f"[{card}] {name}: seeds {t['seeds']}, mismatches "
                    f"{t['mismatches']}, escalations {t['escalations']}, "
                    f"vote launches {t['vote_launches']}, "
                    f"{t['seconds']:.1f} s")
    phase_s = time.perf_counter() - t_phase
    log("fuzz", f"phase fuzz {phase_s:.1f} s (the big seed's tool run "
                f"{big_got['engine_oracle_s']:.1f} s engine + oracle, beside "
                f"the rest)")
    if failures:
        raise AssertionError("fuzz: " + "; ".join(failures))
    return dict(card=card, seeds=list(FUZZ_SEEDS),
                multiprocess_seeds=list(FUZZ_MH_SEEDS), runners=tally,
                big=big_got, seconds=phase_s)


def genome_dir() -> str:
    return os.path.join(CACHE, f"wgs{WGS_MB}mb_{WGS_SNPS}snp_{WGS_READS}r")


def tool_command(tool: str, *args) -> list:
    return [sys.executable, "-m", f"vargeno_tpu_torch.tools.{tool}",
            *map(str, args)]


def start_genome_background(go: str):
    """Phase genome (a) and (e), started after the build in a session of
    their own and run beside the phases that time no reads/s: (a) the
    rehearsal tool's command line (``--phase index``: synthesis of the
    genome, the VCF, the 262,144 reads and the 2,097,152 endurance reads,
    then the index build; host-only), then, once the file ``go`` exists
    (the main process makes it when the timed kernel and bench phases are
    over), (e) the endurance tool's command line: three fresh interpreters
    over the 2,097,152 reads on the sharded dictionary at D = 1, leg B
    killed at a checkpoint past half the stream, leg C resumed."""
    import shlex

    d = genome_dir()
    os.makedirs(d, exist_ok=True)
    prep = tool_command("rehearse_wgs", "--phase", "index", "--mb", WGS_MB,
                        "--snps", WGS_SNPS, "--reads", WGS_READS,
                        "--extra-reads", WGS_EXTRA_READS, "--cache", d)
    endure = tool_command(
        "endurance_wgs", "--cache", d, "--mb", WGS_MB, "--snps", WGS_SNPS,
        "--base-reads", WGS_READS, "--reads", WGS_EXTRA_READS, "--device",
        DEVICE, "--batch", BATCH, "--checkpoint-every", WGS_CHECKPOINT_EVERY,
        "--kill-after-frac", 0.5)
    script = (f"{shlex.join(prep)} && while [ ! -e {shlex.quote(go)} ]; "
              f"do sleep 1; done && {shlex.join(endure)}")
    return start_session(["/bin/sh", "-c", script])


def finish_tool(proc, timeout: float, tag: str, keys) -> dict:
    """Wait for a tool run started in a session of its own (the whole
    session killed once ``timeout`` has passed), print its output under
    ``tag`` and return its JSON lines ``{key: ...}`` for ``keys`` (a key
    it printed no line for is missing). A non-zero exit fails the phase."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{tag}: the tool did not finish within "
                           f"{timeout} s") from None
    finally:
        try:   # the tool and whatever of its session still runs
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    got = {}
    for line in out.splitlines():
        log(tag, line)
        for key in keys:
            if line.startswith("{\"%s\"" % key):
                got[key] = json.loads(line)[key]
    if proc.returncode:
        raise RuntimeError(f"{tag}: the tool exited {proc.returncode}")
    return got


def endurance_summary(card: str, end: dict) -> dict:
    """Phase genome (e)'s result: leg B killed at a checkpoint past half
    the stream and before its end, leg C's VCF byte-identical to leg A's
    (the tool checks both and says ``ok``), and the vote kernel launched
    in legs A and C (counted in each leg's process)."""
    legs = end.get("legs", {})
    geno = {k: legs.get(k, {}).get("geno") or {} for k in "ABC"}
    if not end.get("ok") or not legs["B"]["killed"] or not all(
            geno[k].get("vote_launches", 0) > 0 for k in "AC"):
        raise AssertionError(f"genome: endurance failed: {end}")
    log("genome", f"[{card}] endurance: {end['reads']} reads; leg B "
                  f"killed at checkpoint offset {end['killed_at_offset']} "
                  f"(kill point {end['kill_at']}); leg C resumed in "
                  f"{legs['C']['seconds']:.1f} s (streamed "
                  f"{geno['C']['reads']} reads in {geno['C']['seconds']:.2f}"
                  f" s); the resumed VCF is byte-identical to leg A's "
                  f"({end['vcf_bytes']} B); legs A / B / C "
                  f"{legs['A']['seconds']:.1f} / {legs['B']['seconds']:.1f} "
                  f"/ {legs['C']['seconds']:.1f} s; vote launches A "
                  f"{geno['A']['vote_launches']}, C "
                  f"{geno['C']['vote_launches']}")
    return dict(
        reads=end["reads"], kill_at=end["kill_at"],
        killed_at_offset=end["killed_at_offset"],
        vcf_bytes=end["vcf_bytes"], seconds=end["seconds"],
        legs={k: dict(wall_s=legs[k]["seconds"], killed=legs[k]["killed"],
                      **{f: geno[k].get(f) for f in (
                          "reads", "seconds", "reads_s", "resumed_from",
                          "vote_launches", "setup_s", "load_s",
                          "peak_device_bytes", "index_device_bytes",
                          "peak_rss_bytes")})
              for k in "ABC"})


def host_memory() -> dict:
    """The host's MemTotal and the free bytes of the cache's file system."""
    import shutil

    with open("/proc/meminfo") as f:
        total = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemTotal:"))
    return dict(mem_total=total, disk_free=shutil.disk_usage(CACHE).free)


def phase_genome(card: str, bg: dict) -> dict:
    """Genome scale on one card, at the JAX package's mid-scale point: a
    300 Mb genome, 3,000,000 SNPs, 262,144 reads of 101 bp, batch_reads
    32768, default capacities with escalation. (a) and (e) ran beside the
    earlier phases (``start_genome_background``; ``bg``: their JSON lines).
    (b) The hash-table runner (GenoRunner): derive the tables on the host,
    carry them to the card, stream the reads; reads/s (index load and
    derivation excluded), peak device memory, the index's device bytes, no
    overflow left, the vote kernel launched (count set to 0 just before
    the pass, read just after), and the bare vote launch timed on the
    first forward batch's own records. (c) With that index freed, the
    sharded dictionary at D = 1: the same numbers, counts equal to (b)'s
    at every site. (d) Oracle spot parity: 2,048 sampled reads through the
    D = 1 runner and the port's sequential oracle, 0 mismatches over every
    site. (e) is checked here (``endurance_summary``)."""
    import numpy as np
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import make_mesh
    from vargeno_tpu_torch.engine.device_index import from_numpy, host_fields
    from vargeno_tpu_torch.engine.geno import GenoRunner, _encoder
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes, iter_read_batches
    from vargeno_tpu_torch.kernels.vote import vote_scan_records
    from vargeno_tpu_torch.tools import rehearse_wgs

    t_phase = time.perf_counter()
    prep = bg.get("index", {})
    d = genome_dir()
    prefix = os.path.join(d, "wgs")
    fq = os.path.join(d, "reads.fq")
    L, K = autosize_shapes(fq)
    cfg = GenoConfig(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
                     ht_target_load=HT_LOAD)
    host = host_memory()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    index = store.load(prefix)
    load_s = time.perf_counter() - t0
    n_sites = int(index.sites.pos.shape[0])
    n_ref, n_snp = int(index.ref.kmers.shape[0]), int(index.snp.kmers.shape[0])
    log("genome", f"[{card}] {WGS_MB} Mb, {n_sites} sites, {n_ref} ref rows, "
                  f"{n_snp} snp rows; synthesis {prep.get('gen_s')} s, extra "
                  f"reads {prep.get('extra_reads_s')} s, index build "
                  f"{prep.get('build_s')} s, {prep.get('disk_bytes')} B on "
                  f"disk, the builder's peak RSS {prep.get('peak_rss_bytes')} "
                  f"B; index load (mmap) {load_s:.2f} s; host MemTotal "
                  f"{host['mem_total']} B, free disk {host['disk_free']} B")
    if n_sites != WGS_SNPS:
        raise AssertionError(f"genome: {n_sites} sites, not {WGS_SNPS}")
    out = dict(card=card, mb=WGS_MB, snps=WGS_SNPS, reads=WGS_READS,
               batch_reads=BATCH, ref_rows=n_ref, snp_rows=n_snp,
               prep=prep, load_s=load_s, **host)

    # (b) the hash-table runner. Its derived tables are not written to the
    # index's derived_torch/ cache (prefix dropped): nothing in the run
    # reads them back, and the 34 GB table would take half of the 75 GB an
    # H100 host this phase was sized on had free
    torch.cuda.reset_peak_memory_stats()
    rss0 = rehearse_wgs.peak_rss()
    t0 = time.perf_counter()
    fields, statics = host_fields(dataclasses.replace(index, prefix=None),
                                  HT_LOAD)
    derive_s = time.perf_counter() - t0
    table_b = int(fields["both_ht"].nbytes)
    t0 = time.perf_counter()
    dix = from_numpy(fields, statics, DEVICE)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del fields
    derive_rss = rehearse_wgs.peak_rss()
    runner = GenoRunner(index, cfg, device=DEVICE, dix=dix)
    vote_scan_records.launches = 0
    t0 = time.perf_counter()
    runner.consume_fastq(fq)
    torch.cuda.synchronize()
    geno_s = time.perf_counter() - t0
    launches = vote_scan_records.launches
    check_no_overflow(runner, "genome/hash table")
    if launches <= 0:
        raise AssertionError("genome/hash table: the vote kernel was never "
                             "launched")
    ht_rc, ht_ac = runner.host_counts()
    if ht_rc.shape != (n_sites + 1,) or int(ht_rc.sum() + ht_ac.sum()) <= 0:
        raise AssertionError("genome/hash table: empty or misshapen counts")
    out["hash_table"] = dict(
        derive_s=derive_s, upload_s=upload_s, table_bytes=table_b,
        chain=dix.both_ht_chain, buckets=dix.both_ht_nb,
        derived_cache_bytes=0,
        host_peak_rss_before=rss0, host_peak_rss=derive_rss,
        reads_s=runner.n_reads / geno_s, geno_s=geno_s,
        peak_bytes=torch.cuda.max_memory_allocated(),
        index_bytes=dix.nbytes(), vote_launches=launches,
        escalations=runner.n_escalations, retry_reads=runner.n_retry_reads,
        n_processed=runner.stats_totals["n_processed"])
    log("genome", f"[{card}] hash table: derive {derive_s:.2f} s on the host "
                  f"(table {table_b} B, {dix.both_ht_nb} buckets, chain "
                  f"{dix.both_ht_chain}; cold: 0 B written to the derived "
                  f"cache, so no warm derivation), upload {upload_s:.2f} s, "
                  f"host peak RSS {derive_rss} B; {runner.n_reads} reads in "
                  f"{geno_s:.3f} s = {runner.n_reads / geno_s:.1f} reads/s "
                  f"(index load and derivation excluded); peak device "
                  f"memory {out['hash_table']['peak_bytes']} B, index "
                  f"{dix.nbytes()} B on the card; escalations "
                  f"{runner.n_escalations}, retry reads "
                  f"{runner.n_retry_reads}, vote launches {launches}, "
                  f"n_processed {runner.stats_totals['n_processed']}")

    # the bare vote launch on a 300 Mb step's own records
    kept = []

    def keeping_vote(ev_idx, ev_meta, ev_total, C):
        if not kept:
            kept.append(((ev_idx, ev_meta, ev_total), C))
        return vote_scan_records(ev_idx, ev_meta, ev_total, C)

    b = next(iter(iter_read_batches(fq, BATCH, L, K)))
    GenoRunner(index, runner._cfg_run, device=DEVICE, dix=dix,
               vote=keeping_vote).run_batch(_encoder(K)(b.codes, b.n_kmers),
                                            b.qual)
    out["vote_on_step"] = time_vote_on_step("genome", card, *kept[0])
    del runner, dix, kept, b
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the sharded dictionary at D = 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = ShardedDictGenoRunner(index, make_mesh(1), cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    vote_scan_records.launches = 0
    t0 = time.perf_counter()
    runner.consume_fastq(fq)
    torch.cuda.synchronize()
    geno_s = time.perf_counter() - t0
    launches = vote_scan_records.launches
    check_no_overflow(runner, "genome/sharded dictionary")
    rc, ac = runner.host_counts()
    if not (np.array_equal(rc, ht_rc) and np.array_equal(ac, ht_ac)):
        bad = int(((rc != ht_rc) | (ac != ht_ac)).sum())
        raise AssertionError(f"genome: the D = 1 sharded dictionary's counts "
                             f"differ from the hash table's at {bad} sites")
    if launches <= 0:
        raise AssertionError("genome/sharded dictionary: the vote kernel was "
                             "never launched")
    out["sharded_d1"] = dict(
        setup_s=setup_s, reads_s=runner.n_reads / geno_s, geno_s=geno_s,
        peak_bytes=torch.cuda.max_memory_allocated(),
        index_bytes=runner.device_bytes(), vote_launches=launches,
        escalations=runner.n_escalations,
        route_overflow=runner.stats_totals["route_overflow"],
        final_route_factor=runner._cfg_run.route_factor,
        retry_reads=runner.n_retry_reads)
    log("genome", f"[{card}] sharded dictionary, D = 1: partition + upload "
                  f"{setup_s:.2f} s; {runner.n_reads} reads in {geno_s:.3f} "
                  f"s = {runner.n_reads / geno_s:.1f} reads/s; counts equal "
                  f"to the hash table's at all {n_sites} sites; peak device "
                  f"memory {out['sharded_d1']['peak_bytes']} B, index "
                  f"{runner.device_bytes()} B on the card; escalations "
                  f"{runner.n_escalations} (route_factor {cfg.route_factor} "
                  f"-> {runner._cfg_run.route_factor}), vote launches "
                  f"{launches}")

    # (d) oracle spot parity through the same runner
    vote_scan_records.launches = 0
    spot = rehearse_wgs.spot_parity(index, runner, fq, WGS_SPOT)
    spot["vote_launches"] = vote_scan_records.launches
    out["spot"] = spot
    if spot["mismatches"] or spot["overflow"] or spot["increments"] <= 0 \
            or spot["vote_launches"] <= 0 or spot["reads"] != WGS_SPOT:
        raise AssertionError(f"genome: oracle spot parity failed: {spot}")
    log("genome", f"oracle spot parity: {spot['reads']} reads, 0 mismatches "
                  f"over {spot['sites']} sites ({spot['increments']} "
                  f"site-count increments; engine {spot['engine_s']:.2f} s, "
                  f"oracle {spot['oracle_s']:.2f} s), vote launches "
                  f"{spot['vote_launches']}")
    del runner, index
    gc.collect()
    torch.cuda.empty_cache()

    out["endurance"] = endurance_summary(card, bg["endurance"])
    out["seconds"] = time.perf_counter() - t_phase
    log("genome", f"phase genome {out['seconds']:.1f} s")
    return out


def phase_cards(card: str) -> dict:
    """``--all-cards``: the 48 Mb workload, untuned, on every visible card
    (n >= 2), two passes each (the second warm, timed only), every first
    pass's VCF byte-identical to the one-card hash-table pass's, no
    overflow, the vote kernel launched in every process. One process
    driving the n cards from one host thread (the replicated index: shard
    steps in turn) or from a thread a shard (the sharded dictionary),
    against n processes of one card each (``dist/multihost.py``): the
    replicated index over nccl (no data collective: only the launch rate
    differs), the sharded dictionary over nccl and over gloo (the same
    processes; only the all-to-all transport differs)."""
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import ShardedGenoRunner, make_mesh
    from vargeno_tpu_torch.engine.geno import GenoRunner
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn

    n = torch.cuda.device_count()
    if n < 2:
        raise RuntimeError(f"--all-cards needs 2 or more cards, {n} visible")
    d, prefix = real_paths()
    os.makedirs(d, exist_ok=True)
    fa, vcf, fq = make_dataset(d)
    build_or_load_index(fa, vcf, prefix, "cards")
    L, K = autosize_shapes(fq)
    cfg = dict(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
               ht_target_load=HT_LOAD)
    index = store.load(prefix)
    ref_vcf = os.path.join(d, "cards_ref.vcf")
    out = {"cards": n}

    def drive(tag, make):
        """Two passes of one single-process runner; the first pass's VCF
        is written and held against the first runner's (the one-card
        pass), the second pass is timed only."""
        gc.collect()
        torch.cuda.empty_cache()
        for i in range(n):
            torch.cuda.reset_peak_memory_stats(i)
        def sync():
            for i in range(n):
                torch.cuda.synchronize(i)
        t0 = time.perf_counter()
        runner = make()
        sync()
        setup_s = time.perf_counter() - t0
        pass_s = []
        for k in range(2):
            vote_fn.launches = 0
            t0 = time.perf_counter()
            runner.consume_fastq(fq)
            sync()
            pass_s.append(time.perf_counter() - t0)
            if k == 0:
                launches = vote_fn.launches
                check_no_overflow(runner, f"cards/{tag}")
                path = os.path.join(d, f"cards_{len(out)}.vcf")
                runner.write_vcf(vcf, path)
                if len(out) == 1:   # the one-card pass: the reference
                    os.replace(path, ref_vcf)
                else:
                    with open(path) as f, open(ref_vcf) as g:
                        if f.read() != g.read():
                            raise AssertionError(f"cards/{tag}: VCF differs "
                                                 f"from the one-card pass's")
        if launches <= 0:
            raise AssertionError(f"cards/{tag}: the vote kernel was never "
                                 f"launched")
        peaks = [torch.cuda.max_memory_allocated(i) for i in range(n)]
        out[tag] = dict(reads_s=[runner.n_reads / 2 / t for t in pass_s],
                        pass_s=pass_s, setup_s=setup_s,
                        vote_launches=launches, peak_bytes=peaks)
        log("cards", f"[{card}] {tag}: {runner.n_reads // 2} reads a pass, "
                     f"passes {[round(t, 4) for t in pass_s]} s = "
                     f"{[round(runner.n_reads / 2 / t, 1) for t in pass_s]}"
                     f" reads/s (setup {setup_s:.2f} s excluded); vote "
                     f"launches {launches}; peak device memory per card "
                     f"{peaks} B")
        del runner

    cards = [f"{DEVICE}:{i}" for i in range(n)]
    drive("hash table, 1 card", lambda: GenoRunner(
        index, GenoConfig(**cfg), device=cards[0]))
    drive(f"replicated index, 1 process, {n} cards",
          lambda: ShardedGenoRunner(index, make_mesh(devices=cards),
                                    GenoConfig(**cfg)))
    drive(f"sharded dictionary, 1 process, {n} cards (a thread a shard)",
          lambda: ShardedDictGenoRunner(index, make_mesh(devices=cards),
                                        GenoConfig(**cfg)))
    del index
    gc.collect()
    torch.cuda.empty_cache()

    # n processes of one card each: the replicated index and the sharded
    # dictionary over nccl, the sharded dictionary over gloo
    for backend, kinds in (("nccl", ("replicated index",
                                     "sharded dictionary")),
                           ("gloo", ("sharded dictionary",))):
        common = dict(prefix=prefix, fq=fq, vcf_in=vcf, config=cfg,
                      timeout=300, runs=[dict(
                          tag=kind, dict=kind == "sharded dictionary",
                          queued=True, passes=2,
                          out=os.path.join(d, f"cards_{backend}_{i}.vcf"))
                          for i, kind in enumerate(kinds)])
        t0 = time.perf_counter()
        got = finish_cluster(start_cluster(
            f"{n} processes over {backend}", backend,
            [[c] for c in cards], common), 900)
        wall_s = time.perf_counter() - t0
        for run in common["runs"]:
            lines = got.get(run["tag"], [])
            tag = f"{run['tag']}, {n} processes x 1 card, {backend}"
            if len(lines) != n:
                raise AssertionError(f"cards/{tag}: {len(lines)} of {n} "
                                     f"processes reported")
            with open(run["out"]) as f, open(ref_vcf) as g:
                if f.read() != g.read():
                    raise AssertionError(f"cards/{tag}: VCF differs from "
                                         f"the one-card pass's")
            for g in lines:
                if g["overflow"] or g["vote_launches"] <= 0:
                    raise AssertionError(f"cards/{tag}: rank {g['rank']}: "
                                         f"{g}")
            pass_s = [max(g["pass_s"][k] for g in lines) for k in range(2)]
            reads = lines[0]["reads"]
            out[tag] = dict(
                reads_s=[reads / t for t in pass_s], pass_s=pass_s,
                setup_s=[g["setup_s"] for g in lines],
                vote_launches=[g["vote_launches"] for g in lines],
                peak_bytes=[g["peak_bytes"] for g in lines],
                index_bytes=[g["index_bytes"] for g in lines],
                retry_batches=lines[0]["retry_batches"],
                batches=lines[0]["batches"])
            log("cards", f"[{card}] {tag}: VCF byte-identical to the "
                         f"one-card pass's; passes (the slowest process) "
                         f"{[round(t, 4) for t in pass_s]} s = "
                         f"{[round(reads / t, 1) for t in pass_s]} reads/s; "
                         f"{lines[0]['batches'] - lines[0]['retry_batches']}"
                         f" forward + {lines[0]['retry_batches']} lockstep "
                         f"retry batches; per process: vote launches "
                         f"{out[tag]['vote_launches']}, peak device memory "
                         f"{out[tag]['peak_bytes']} B, index "
                         f"{out[tag]['index_bytes']} B, setup "
                         f"{[round(t, 2) for t in out[tag]['setup_s']]} s; "
                         f"cluster wall {wall_s:.1f} s")
    return out


def main() -> int:
    argv = sys.argv[1:]
    parent = None
    if len(argv) == 2 and argv[0] in ("--parent", "--step-ops-of",
                                      "--routed-step-ops-of", "--mh-worker"):
        parent = argv[1]
    elif argv and argv != ["--all-cards"]:
        print("usage: chip_smoke.py [--parent DIR | --all-cards]",
              file=sys.stderr)
        return 2
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
    if argv and argv[0] == "--mh-worker":
        return mh_worker(json.loads(argv[1]))
    if argv and argv[0] in ("--step-ops-of", "--routed-step-ops-of"):
        return step_ops_of(parent, routed=argv[0] == "--routed-step-ops-of")
    if parent:
        parent = inside_checkout(parent)
    sys.path.insert(0, ROOT)
    try:
        from vargeno_tpu_torch import native
        from vargeno_tpu_torch.kernels import _build, gather, vote
    except ImportError as e:
        print(f"error: the vargeno_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    card = card_line()
    print(card, flush=True)
    log("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                  f"numpy {np.__version__}, "
                  f"{torch.cuda.get_device_name(0)} x "
                  f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    vote.load_library()
    gather.load_library()
    if not native.available():
        raise RuntimeError("native host library failed to build (g++)")
    log("build", f"vote + gather kernels (nvcc sm_90a) and the native host "
                 f"library (g++) ready in {time.perf_counter() - t0:.2f} s")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"ptxas {name}: " + line.strip())

    if argv == ["--all-cards"]:
        cards = phase_cards(card)
        log("done", f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"cards": {"card": card, **cards}}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        got = fn(*args)
        log("done", f"phase {name} {time.perf_counter() - t0:.1f} s")
        return got

    # phase genome (a) and then (e) run beside the phases that time no
    # reads/s; (e) takes the card only once the kernel and bench phases
    # are over
    go = os.path.join(genome_dir(), "go")
    if os.path.exists(go):
        os.remove(go)
    bg = start_genome_background(go)
    real_bg = start_real_prep()   # the real phase's dataset and index too
    try:
        vote_t, vote_err = timed("kernel (vote)", phase_kernel_vote)
        gather_t, gather_err = timed("kernel (gather)", phase_kernel_gather)
        rates, gather_launches = timed("bench", phase_bench, card)
        open(go, "w").close()
        timed("golden", phase_golden)
        timed("mesh", phase_mesh)
        fuzz = timed("fuzz", phase_fuzz, card)
        real_prep = timed("real's dataset and index, the rest of their "
                          "wait", finish_tool, real_bg, 600, "real",
                          ("real_prep",))["real_prep"]
        genome_bg = timed("genome (a) and (e), the rest of their wait",
                          finish_tool, bg, 900, "genome",
                          ("index", "endurance"))
    finally:   # on a failure, stop what still runs
        for p in (bg, real_bg):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    real = timed("real", phase_real, card, rates, parent, real_prep)
    routed = timed("routed", phase_routed, card, real)
    mh = timed("multihost", phase_multihost, card, routed)
    genome = timed("genome", phase_genome, card, genome_bg)

    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"mesh": {
        "card": card, "workload": f"{GENOME_MB} Mb, {N_SNPS} SNPs, "
                                  f"{N_READS} reads, batch_reads {BATCH}",
        "hash_table": {"reads_s": real["rate"], "peak_bytes": real["peak"],
                       "index_bytes": real["dix_bytes"],
                       "step_ops": real["step_ops"]},
        **routed, "multihost": mh}}), flush=True)
    print(json.dumps({"fuzz": fuzz}), flush=True)
    print(json.dumps({"genome": genome}), flush=True)
    main_shape = str(KERNEL_SHAPES[0][:3])
    before = real["parent"]
    print(json.dumps({"kernels": [
        {"name": "vote_scan", "route": "cuda",
         "source": "vargeno_tpu_torch/csrc/vote.cu",
         "replaces": "vargeno_tpu/engine/pallas_vote.py:26",
         "launches": real["launches"], "max_abs_err": vote_err,
         "routed_launches": {k: routed[k]["vote_launches"]
                             for k in ("D1", "D2")},
         "multihost_launches_per_process": {
             "48 Mb, 2 processes": mh["mb48"]["vote_launches"],
             **{f"mini {k} {t}": v for k, runs in mh["mini"].items()
                for t, v in runs.items()}},
         "fuzz_launches": {k: v["vote_launches"]
                           for k, v in fuzz["runners"].items()},
         "genome_launches": {
             "hash table": genome["hash_table"]["vote_launches"],
             "sharded dictionary, D = 1":
                 genome["sharded_d1"]["vote_launches"],
             "spot parity": genome["spot"]["vote_launches"],
             **{f"endurance leg {k}": v["vote_launches"]
                for k, v in genome["endurance"]["legs"].items()
                if v["vote_launches"] is not None}},
         "genome_batch_raw_launch_ms": genome["vote_on_step"]["raw_ms"],
         "shape": "(E, B, C) = " + str(KERNEL_SHAPES[0][:3]),
         **vote_t[KERNEL_SHAPES[0][:3]], "library_ms": None,
         "ms_before": before["eb_entry_ms"][main_shape] if before else None,
         "ms_before_of": "this run: the (E, B) entry of the --parent "
                         "checkout, which its step called (null without "
                         "--parent)",
         "ms_of": "the records entry (zero one word, launch)",
         "real_batch_raw_launch_ms": real["real_raw_ms"],
         "real_step_kernel_us": real["real_kernel_us"],
         "kernel_us": real["kernel_us"][main_shape],
         "kernel_us_before": (before["eb_vote_kernel_us"][main_shape]
                              if before else None),
         "step_ops_before": before["step_ops"] if before else None,
         "device_ops_a_step": real["step_ops"],
         "device_ops_a_call": real["vote_call_ops"]},
        {"name": "gather_rows_sum", "route": "cuda",
         "source": "vargeno_tpu_torch/csrc/gather.cu",
         "replaces": "tools/bench_gather.py:245",
         "launches": gather_launches, "max_abs_err": gather_err,
         "shape": "(N, R, W) = " + str(GATHER_MAIN),
         **gather_t[GATHER_MAIN],
         "ms_before_of": "this run: the direct-load kernel, which was the "
                         "only one before, named outright",
         "ms_of": "the wrapper (zero one word, launch the kernel the "
                  "library picks: see kernel)"}]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
