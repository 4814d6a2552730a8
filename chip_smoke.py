#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device  -- require CUDA; print the card's name and power limit (as
   nvidia-smi reports them) and the torch / CUDA / numpy versions.
2. build   -- compile both kernels (nvcc, sm_90a) and the native host
   library (g++) from the sources in this checkout; print the seconds and
   ptxas' register lines.
3. kernel  -- each hand-written kernel against its plain PyTorch version on
   the card, exact equality (integers), median times of both from CUDA
   events, and the least time the card could take for the same work.
   The vote kernel on random event streams with ragged per-read counts at
   (E, B, C) = (96, 32768, 32), (96, 32768, 64), (32, 4096, 16), and at
   the wide tables that overflow escalation reaches, (1200, 4096, 1024)
   and (2000, 1024, 520) (global-workspace table); (32, 4096, 16) and
   (2000, 1024, 520) must overflow their candidate tables. The row-gather
   kernel at (N, R, W) = (65536, 2097152, 32) (the shape of the TPU kernel
   it replaces), (4194304, 2097152, 32), (524288, 524288, 128), with every
   index equal, and with N = 1.
4. bench   -- the gather-rate bench (tools/bench_gather.py) on the card at
   its full table size: the main path of the row-gather kernel, whose
   launches are counted here. Prints its JSON line.
5. golden  -- index the mini fixture and genotype it on the card at
   batch_reads=512: at default capacities; with 640 events and 1024
   candidates a read; with both orientations inline (non-queued); with
   auto-tune on (it must fire); stopped after 8 batches with a checkpoint
   every 4 and resumed by a second runner; as the first sample of a
   two-sample cohort (whose second sample stops after 2 batches and must
   differ). Each VCF must be byte-identical to the reference binary's
   golden output, with the vote kernel launched and no capacity overflow
   left after escalation. Then the filt index: its geno VCF must equal
   golden_filt_output.vcf.
6. real    -- the benchmark workload (one 48 Mb chromosome, 500,000 SNPs,
   262,144 101 bp reads at err_frac=0.15, seed 20260817) at
   batch_reads=32768 and ht_target_load=0.24. This is the main path of
   the vote kernel, whose launches are counted here. Prints index build /
   load seconds, end-to-end reads/s (index load excluded), peak device
   memory and the run's counters; the roofline report of that pass from
   its reads/s, its measured retry fraction and the bench phase's rates; a
   second pass with auto-tune on (reads/s of both, the tuned capacities,
   equal pileup counts required); the first two batches are re-run with
   the plain vote and must give the same counts.

The last two lines are a JSON object describing each kernel and the
result line ``{"ok": true, "device": {...}}``. The dataset and index are
cached under ``.smoke_cache/`` next to this file.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
                 (32, 4096, 16, True), (1200, 4096, 1024, False),
                 (2000, 1024, 520, True)]
# (N, R, W, every index equal); the second is the one the kernels line times
GATHER_SHAPES = [(65536, 2097152, 32, False), (4194304, 2097152, 32, False),
                 (524288, 524288, 128, False), (100000, 2097152, 32, True),
                 (1, 2097152, 32, False)]
GATHER_MAIN = GATHER_SHAPES[1][:3]
DEVICE = "cuda"
# the card's published peaks (H100 SXM data sheet): memory bytes/s, and
# operations/s outside the tensor cores (the float32 rate, taken for the
# kernels' 32-bit integer operations too)
PEAK_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + r.stderr)
    return r.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
def random_events(E, B, C, seed):
    """Event streams with repeating idx values (2C distinct per read, a
    few >= 2**31) and ragged counts; events past ev_n are invalid."""
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
    return ([torch.from_numpy(a).to(dev) for a in (idx, k, isnb, valid)],
            torch.from_numpy(ev_n).to(dev))


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the operation rate."""
    t_b, t_o = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def phase_kernel_vote():
    import torch

    from vargeno_tpu_torch.kernels.vote import vote_scan, vote_scan_plain
    from vargeno_tpu_torch.utils.profiling import device_ms

    timing = {}
    max_err = 0
    for E, B, C, must_overflow in KERNEL_SHAPES:
        args, ev_n = random_events(E, B, C, seed=E * 1000 + C)
        got = vote_scan(*args, C, ev_n)
        want = vote_scan_plain(*args, C, ev_n)
        torch.cuda.synchronize()
        for name, g, w in zip(("process", "target", "cand_overflow"),
                              got, want):
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"vote kernel != plain at "
                                     f"{(E, B, C)}: {name} max err {err}")
        ovf = int(got[2])
        if must_overflow and ovf <= 0:
            raise AssertionError(f"{(E, B, C)} did not overflow")
        ms = device_ms(lambda: vote_scan(*args, C, ev_n), DEVICE, reps=20)
        plain_ms = device_ms(lambda: vote_scan_plain(*args, C, ev_n), DEVICE,
                             reps=5)
        # the kernel stops at each read's ev_n, so the work this input
        # needs is its n_ev events: 10 B each (idx 4, k 4, isnb 1, valid 1)
        # plus 4 B of count in and 9 B out a read; an event is compared
        # with up to min(C, E) slots and updates ~16 words of state
        n_ev = int(ev_n.sum())
        b_ms, b_by = bound(n_ev * 10 + B * 13, n_ev * (min(C, E) + 16))
        timing[E, B, C] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by)
        log("kernel", f"vote (E, B, C) = {(E, B, C)}: exact match "
                      f"(processed {int(got[0].sum())}, cand_overflow "
                      f"{ovf}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"bound {b_ms:.4f} ms by {b_by} for its {n_ev} "
                      f"events")
    return timing, max_err


def phase_kernel_gather():
    import numpy as np
    import torch

    from vargeno_tpu_torch.kernels.gather import (gather_rows_sum,
                                                  gather_rows_sum_plain)
    from vargeno_tpu_torch.utils.profiling import device_ms

    rng = np.random.default_rng(11)
    dev = torch.device(DEVICE)
    timing = {}
    max_err = 0
    tables: dict = {}
    for N, R, W, same in GATHER_SHAPES:
        if (R, W) not in tables:
            tables.clear()   # one 256 MiB table on the card at a time
            tables[R, W] = torch.from_numpy(rng.integers(
                0, 2**32, (R, W), dtype=np.uint32).view(np.int32)).to(dev)
        table = tables[R, W]
        idx_np = rng.integers(0, R, N, dtype=np.int32)
        if same:
            idx_np[:] = idx_np[0]
        for dtype in (torch.int64, torch.int32):
            idx = torch.from_numpy(idx_np).to(dev).to(dtype)
            got = gather_rows_sum(table, idx)
            want = gather_rows_sum_plain(table, idx)
            torch.cuda.synchronize()
            err = abs(int(got) - int(want))
            max_err = max(max_err, err)
            if err:
                raise AssertionError(
                    f"gather kernel != plain at {(N, R, W)} {dtype}: "
                    f"{int(got)} vs {int(want)}")
        ms = device_ms(lambda: gather_rows_sum(table, idx), DEVICE, reps=20)
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
        timing[N, R, W] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               distinct_rows=n_rows)
        log("kernel", f"gather (N, R, W) = {(N, R, W)}"
                      f"{' (one row)' if same else ''}: exact match (sum "
                      f"{int(got)}); kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, index_select+sum {lib_ms:.4f} ms, "
                      f"bound {b_ms:.4f} ms by {b_by} for its {n_rows} "
                      f"distinct rows")
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
    from vargeno_tpu_torch.kernels.vote import vote_scan

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

    def run(tag, cfg, golden, index=index, dix=dix, **runner_kw):
        runner = GenoRunner(index, cfg, device=DEVICE, dix=dix, **runner_kw)
        before = vote_scan.launches
        t0 = time.perf_counter()
        runner.consume_fastq(fq)
        runner.write_vcf(vcf_in, out)
        check(tag, runner, vote_scan.launches - before,
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
    before = vote_scan.launches
    t0 = time.perf_counter()
    second.consume_fastq(fq, checkpoint_path=ck)
    second.write_vcf(vcf_in, out)
    check(f"checkpoint at {first.n_reads} reads, resumed", second,
          vote_scan.launches - before, time.perf_counter() - t0, golden)

    # two-sample cohort: the second sample stops after 2 batches
    cohort = CohortRunner(index, ["full", "part"], base, device=DEVICE)
    before = vote_scan.launches
    t0 = time.perf_counter()
    cohort.consume_sample("full", fq)
    cohort.consume_sample("part", fq, limit_batches=2)
    outs = cohort.write_vcfs(vcf_in, os.path.join(d, "cohort_{sample}.vcf"))
    check("cohort sample 1 of 2", cohort._runner,
          vote_scan.launches - before, time.perf_counter() - t0, golden,
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


def phase_real(card: str, gather_rates: dict):
    import numpy as np
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.engine.device_index import build_device_index
    from vargeno_tpu_torch.engine.geno import GenoRunner, _encoder
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes, iter_read_batches
    from vargeno_tpu_torch.kernels.vote import vote_scan, vote_scan_plain
    from vargeno_tpu_torch.utils.roofline import roofline

    d = os.path.join(CACHE, f"bench{GENOME_MB}mb_{N_SNPS}snp_{N_READS}r_"
                            f"e{ERR_FRAC}_s{SEED}")
    os.makedirs(d, exist_ok=True)
    fa, vcf, fq = make_dataset(d)
    prefix = os.path.join(d, "idx")
    build_s = build_or_load_index(fa, vcf, prefix, "real")

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
    vote_scan.launches = 0
    t0 = time.perf_counter()
    runner.consume_fastq(fq)
    if on_cuda:
        torch.cuda.synchronize()
    geno_s = time.perf_counter() - t0
    launches = vote_scan.launches
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

    # cross-check: the first two batches, kernel vote vs plain vote
    encode = _encoder(K)
    batches = []
    for b in iter_read_batches(fq, BATCH, L, K):
        batches.append((encode(b.codes, b.n_kmers), b.qual))
        if len(batches) == 2:
            break
    outs = []
    for vote in (vote_scan, vote_scan_plain):
        r = GenoRunner(index, runner._cfg_run, device=DEVICE, dix=dix,
                       vote=vote)
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
    return dict(build_s=build_s, load_s=load_s, rate=rate,
                tuned_rate=tuned_rate, peak=peak, launches=launches,
                roofline=report)


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
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

    vote_t, vote_err = phase_kernel_vote()
    gather_t, gather_err = phase_kernel_gather()
    rates, gather_launches = phase_bench(card)
    phase_golden()
    real = phase_real(card, rates)

    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": "vote_scan", "route": "cuda",
         "source": "vargeno_tpu_torch/csrc/vote.cu",
         "replaces": "vargeno_tpu/engine/pallas_vote.py:26",
         "launches": real["launches"], "max_abs_err": vote_err,
         "shape": "(E, B, C) = " + str(KERNEL_SHAPES[0][:3]),
         **vote_t[KERNEL_SHAPES[0][:3]], "library_ms": None},
        {"name": "gather_rows_sum", "route": "cuda",
         "source": "vargeno_tpu_torch/csrc/gather.cu",
         "replaces": "tools/bench_gather.py:245",
         "launches": gather_launches, "max_abs_err": gather_err,
         "shape": "(N, R, W) = " + str(GATHER_MAIN),
         **gather_t[GATHER_MAIN]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
