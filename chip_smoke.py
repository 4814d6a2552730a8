#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device  -- require CUDA; print the card's name and power limit (as
   nvidia-smi reports them) and the torch / CUDA / numpy versions.
2. build   -- compile the vote kernel (nvcc, sm_90a) and the native host
   library (g++) from the sources in this checkout; print the seconds.
3. kernel  -- the hand-written vote kernel against its plain PyTorch version
   on the card, on random event streams with ragged per-read counts at
   (E, B, C) = (96, 32768, 32), (96, 32768, 64), (32, 4096, 16), and at
   the wide tables that overflow escalation reaches, (1200, 4096, 1024)
   and (2000, 1024, 520) (global-workspace table); results must be exactly
   equal (integers), and (32, 4096, 16) and (2000, 1024, 520) must
   overflow their candidate tables. Median times of both versions from
   CUDA events.
4. golden  -- index the mini fixture and genotype it on the card at
   batch_reads=512, once at default capacities and once with 640 events
   and 1024 candidates a read: each VCF must be byte-identical to the
   reference binary's golden output, with the vote kernel launched and no
   capacity overflow left after escalation.
5. real    -- the benchmark workload (one 48 Mb chromosome, 500,000 SNPs,
   262,144 101 bp reads at err_frac=0.15, seed 20260817) at
   batch_reads=32768 and ht_target_load=0.24. This is the main path whose
   kernel launches are counted. Prints index build / load seconds,
   end-to-end reads/s (index load excluded), peak device memory and the
   run's counters; the first two batches are re-run with the plain vote
   and must give the same counts.

The last two lines are a JSON object describing each kernel and the
result line ``{"ok": true, "device": {...}}``. The dataset and index are
cached under ``.smoke_cache/`` next to this file.
"""

from __future__ import annotations

import json
import os
import statistics
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
DEVICE = "cuda"


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


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` timed runs, each
    bracketed by CUDA events, after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernel():
    import torch

    from vargeno_tpu_torch.kernels.vote import vote_scan, vote_scan_plain

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
        ms = cuda_ms(lambda: vote_scan(*args, C, ev_n), reps=20)
        plain_ms = cuda_ms(lambda: vote_scan_plain(*args, C, ev_n), reps=5)
        timing[E, B, C] = (ms, plain_ms)
        log("kernel", f"(E, B, C) = {(E, B, C)}: exact match "
                      f"(processed {int(got[0].sum())}, cand_overflow "
                      f"{ovf}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return timing, max_err


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
    from vargeno_tpu_torch.engine.geno import GenoRunner
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.kernels.vote import vote_scan

    d = os.path.join(CACHE, "mini")
    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, "mini")
    build_or_load_index(os.path.join(FIX, "genome.fa"),
                        os.path.join(FIX, "snps.vcf"), prefix, "golden")
    index = store.load(prefix)
    base = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
    with open(os.path.join(FIX, "golden_output.vcf")) as g:
        golden = g.read()
    for caps in ({}, dict(events_per_read=640, candidates_per_read=1024)):
        runner = GenoRunner(index, GenoConfig(**base, **caps), device=DEVICE)
        before = vote_scan.launches
        t0 = time.perf_counter()
        runner.consume_fastq(os.path.join(FIX, "reads.fq"))
        out = os.path.join(d, "out.vcf")
        runner.write_vcf(os.path.join(FIX, "snps.vcf"), out)
        dt = time.perf_counter() - t0
        launches = vote_scan.launches - before
        with open(out) as f:
            if f.read() != golden:
                raise AssertionError(f"mini VCF {caps} differs from "
                                     f"golden_output.vcf")
        check_no_overflow(runner, "golden")
        if DEVICE == "cuda" and launches <= 0:
            raise AssertionError("golden run never launched the vote kernel")
        log("golden", f"caps {caps or 'default'}: VCF byte-identical to "
                      f"golden_output.vcf; {runner.n_reads} reads in "
                      f"{dt:.2f} s, vote launches {launches}, escalations "
                      f"{runner.n_escalations}")


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


def phase_real(card: str):
    import numpy as np
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.engine.device_index import build_device_index
    from vargeno_tpu_torch.engine.geno import GenoRunner, _encoder
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes, iter_read_batches
    from vargeno_tpu_torch.kernels.vote import vote_scan, vote_scan_plain

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
    return dict(build_s=build_s, load_s=load_s, rate=rate, peak=peak,
                launches=launches)


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
        from vargeno_tpu_torch.kernels import vote
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
    log("build", f"vote kernel (nvcc sm_90a) ready in "
                 f"{time.perf_counter() - t0:.2f} s")
    for line in vote.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("native host library failed to build (g++)")
    log("build", f"native host library (g++) ready in "
                 f"{time.perf_counter() - t0:.2f} s")

    timing, max_err = phase_kernel()
    phase_golden()
    real = phase_real(card)

    ms, plain_ms = timing[KERNEL_SHAPES[0][:3]]
    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "vote_scan", "route": "cuda",
        "source": "vargeno_tpu_torch/csrc/vote.cu",
        "replaces": "vargeno_tpu/engine/pallas_vote.py:26",
        "launches": real["launches"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
