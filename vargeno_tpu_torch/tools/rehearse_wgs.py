"""Genome-scale rehearsal (port of ``tools/rehearse_wgs.py``).

Synthesizes a genome of ``--mb`` megabases and a VCF of ``--snps`` SNPs
(the reference's headline workload is hg19 + dbSNP-common: ``--mb 3000
--snps 5000000``), builds the index, then genotypes a read sample on a
torch device through the sharded dictionary (``dist/sharded_dict.py``, D =
the number of ``--devices``, 1 by default) or the hash-table runner
(``--runner ht``, ``engine/geno.py``). Logs phase timings with the
process's peak RSS, and with the device's peak memory and the index's
device bytes at the end of ``geno``.

    python -m vargeno_tpu_torch.tools.rehearse_wgs [--mb 3000]
        [--snps 5000000] [--reads 65536] [--cache DIR] [--phase all]
        [--runner sharded|ht] [--device cuda] [--devices cuda:0,...]
        [--extra-reads N] [--spot-parity N] [--checkpoint P]

The inputs come from the same generator draws as the JAX tool's and are
the same bytes: the FASTA (written in chunks), the VCF, and the FASTQ of
reads off two haplotypes with 15% single-base errors, half of them
reverse-complemented. Memory-aware by construction: the genome is made and
written in chunks as uint8 codes, and reads are sliced from the codes.

Phases: ``gen`` writes the inputs (and ``reads_{N}.fq`` with
``--extra-reads N``), ``index`` also builds the index, ``geno`` (and
``all``) also genotypes. The engine runs on the card unless ``--device
cpu`` is asked for. The end of ``index`` and of ``geno`` prints one JSON
line each (``{"index": ...}``, ``{"geno": ...}``) with what it measured.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import threading
import time

import numpy as np

T0 = time.time()


def peak_rss() -> int:
    """Peak resident bytes of this process (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def log(msg):
    print(f"[{time.time()-T0:8.1f}s peak_rss={peak_rss() / 1e9:6.1f}GB] "
          f"{msg}", flush=True)


BASES = np.frombuffer(b"ACGT", np.uint8)


def default_cache() -> str:
    return os.path.join(tempfile.gettempdir(), "vgt_wgs")


def gen_inputs(cache, mb, n_snps, n_reads, read_len=101, seed=20260819):
    fa = os.path.join(cache, "genome.fa")
    vcf = os.path.join(cache, "snps.vcf")
    fq = os.path.join(cache, "reads.fq")
    marker = os.path.join(cache, f"ready_{mb}_{n_snps}_{n_reads}")
    if os.path.exists(marker):
        return fa, vcf, fq
    rng = np.random.default_rng(seed)
    n = mb * 1_000_000
    log(f"generating {mb} Mb genome codes")
    codes = rng.integers(0, 4, n, dtype=np.uint8)

    log("writing FASTA (chunked)")
    W = 70
    with open(fa, "wb") as f:
        f.write(b">chrW1\n")
        CH = 50_000_000 - (50_000_000 % W)
        for i in range(0, n, CH):
            seg = BASES[codes[i:i + CH]]
            m = seg.shape[0]
            pad = (-m) % W
            if pad:
                seg = np.concatenate([seg, np.full(pad, ord("\n"),
                                                   np.uint8)])
            rows = seg.reshape(-1, W)
            out = np.concatenate(
                [rows, np.full((rows.shape[0], 1), ord("\n"), np.uint8)],
                axis=1)
            buf = out.reshape(-1)
            if pad:   # strip pad bytes (newlines already placed)
                buf = np.concatenate([out[:-1].reshape(-1),
                                      rows[-1][:m - (rows.shape[0] - 1) * W],
                                      np.frombuffer(b"\n", np.uint8)])
            f.write(buf.tobytes())

    log(f"writing {n_snps} VCF rows")
    pos = np.sort(rng.choice(np.arange(64, n - 64, dtype=np.int64),
                             size=n_snps, replace=False))
    ref_codes = codes[pos]
    alt_codes = (ref_codes + rng.integers(1, 4, n_snps).astype(np.uint8)) % 4
    caf = rng.choice([0.99, 0.9, 0.7], n_snps)
    with open(vcf, "w") as f:
        f.write("##fileformat=VCFv4.0\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        CH = 500_000
        for i in range(0, n_snps, CH):
            rows = []
            for j in range(i, min(i + CH, n_snps)):
                rows.append(
                    f"chrW1\t{pos[j]+1}\trs{j}\t{chr(BASES[ref_codes[j]])}"
                    f"\t{chr(BASES[alt_codes[j]])}\t.\t.\t"
                    f"RS={j};CAF={caf[j]:.4g},{1-caf[j]:.4g}")
            f.write("\n".join(rows) + "\n")

    log(f"writing {n_reads} reads")
    # alt haplotype: het sites on hap1, hom-alt on both
    gt = rng.choice([0, 1, 2], n_snps, p=[0.5, 0.3, 0.2])
    hap1 = codes.copy()
    sel = gt >= 1
    hap1[pos[sel]] = alt_codes[sel]
    sel2 = gt == 2
    hap0 = codes.copy()
    hap0[pos[sel2]] = alt_codes[sel2]
    _write_reads(fq, rng, hap0, hap1, n_reads, read_len, b"r")
    del hap0, hap1, codes
    with open(marker, "w") as f:
        f.write("ok")
    log("inputs ready")
    return fa, vcf, fq


def _write_reads(fq, rng, hap0, hap1, n_reads, read_len, tag):
    """Reads ``@{tag}{i}`` off the two haplotypes, drawn in chunks of 8,192
    exactly as the JAX tool draws them."""
    n = hap0.shape[0]
    comp = np.array([3, 2, 1, 0], np.uint8)
    with open(fq, "wb") as f:
        CH = 8192
        for i in range(0, n_reads, CH):
            m = min(CH, n_reads - i)
            starts = rng.integers(0, n - read_len, m)
            hap = rng.integers(0, 2, m)
            win = starts[:, None] + np.arange(read_len)[None, :]
            r = np.where(hap[:, None] == 0, hap0[win], hap1[win])
            err = rng.random(m) < 0.15
            kidx = rng.integers(0, read_len // 32, m)
            epos = kidx * 32 + rng.integers(0, 32, m)
            es = np.flatnonzero(err)
            r[es, epos[es]] = (r[es, epos[es]]
                               + rng.integers(1, 4, es.size).astype(
                                   np.uint8)) % 4
            rc = rng.random(m) < 0.5
            r = np.where(rc[:, None], comp[r[:, ::-1]], r)
            qual = np.full((m, read_len), ord("I"), np.uint8)
            qual[es, kidx[es]] = ord("0")
            seqs = BASES[r]
            f.write(b"".join(
                b"@%s%d\n%s\n+\n%s\n" % (tag, i + j, seqs[j].tobytes(),
                                         qual[j].tobytes())
                for j in range(m)))


def _read_genome_codes(fa):
    """FASTA -> uint8 codes (single-sequence file written by gen_inputs)."""
    raw = np.fromfile(fa, np.uint8)
    start = int(np.flatnonzero(raw == ord("\n"))[0]) + 1
    body = raw[start:]
    body = body[body != ord("\n")]
    codes = np.full(body.shape[0], 4, np.uint8)
    for i, b in enumerate(b"ACGT"):
        codes[body == b] = i
    return codes


def gen_extra_reads(cache, fa, vcf, n_reads, read_len=101, seed=77):
    """More reads from the EXISTING genome + VCF (a fresh genotype
    assignment) without touching the index: the exactness check is oracle
    parity on the same reads, not a predetermined truth set."""
    fq = os.path.join(cache, f"reads_{n_reads}.fq")
    if os.path.exists(fq):
        return fq
    rng = np.random.default_rng(seed)
    log(f"extra reads: loading genome codes from {fa}")
    codes = _read_genome_codes(fa)
    log("extra reads: parsing VCF positions")
    pos_l, alt_l = [], []
    lut = {b"A"[0]: 0, b"C"[0]: 1, b"G"[0]: 2, b"T"[0]: 3}
    with open(vcf, "rb") as f:
        for line in f:
            if line.startswith(b"#"):
                continue
            parts = line.split(b"\t", 5)
            pos_l.append(int(parts[1]) - 1)
            alt_l.append(lut[parts[4][0]])
    pos = np.asarray(pos_l, np.int64)
    alt_codes = np.asarray(alt_l, np.uint8)
    gt = rng.choice([0, 1, 2], pos.shape[0], p=[0.5, 0.3, 0.2])
    hap1 = codes.copy()
    sel = gt >= 1
    hap1[pos[sel]] = alt_codes[sel]
    hap0 = codes.copy()
    sel2 = gt == 2
    hap0[pos[sel2]] = alt_codes[sel2]
    log(f"extra reads: writing {n_reads}")
    tmp = fq + ".tmp"   # a reader never sees a partial file under fq
    _write_reads(tmp, rng, hap0, hap1, n_reads, read_len, b"x")
    os.replace(tmp, fq)
    del hap0, hap1, codes
    log("extra reads ready")
    return fq


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def geno_config(batch: int):
    """The tool's engine config (the JAX tool's): 128-base reads, 4 k-mer
    slots, 24 events a read; overflow escalation keeps it exact."""
    from ..config import GenoConfig

    return GenoConfig(batch_reads=batch, max_read_len=128,
                      max_kmers_per_read=4, events_per_read=24)


def make_runner(index, cfg, runner: str = "sharded", device: str = "cuda",
                devices=None):
    """The sharded-dictionary runner over ``devices`` (D = their count;
    ``[device]`` by default), or the hash-table GenoRunner on ``device``."""
    if runner == "ht":
        from ..engine.geno import GenoRunner

        return GenoRunner(index, cfg, device=device)
    from ..dist.sharded_dict import ShardedDictGenoRunner
    from ..dist.sharding import make_mesh

    return ShardedDictGenoRunner(
        index, make_mesh(devices=list(devices or [device])), cfg)


def index_device_bytes(runner) -> int:
    """Bytes of the index tables on the runner's devices."""
    if hasattr(runner, "device_bytes"):
        return runner.device_bytes()
    return runner.dix.nbytes()


def _devices(runner) -> list:
    return list(runner.mesh.devices) if hasattr(runner, "mesh") \
        else [runner.device]


def peak_device_bytes(runner):
    """The largest peak of allocated bytes over the runner's CUDA devices
    since their last reset, or None off the card."""
    import torch

    return max((torch.cuda.max_memory_allocated(d) for d in _devices(runner)
                if d.type == "cuda"), default=None)


def stream(runner, fq, limit_batches=None, checkpoint=None,
           checkpoint_every=16, progress_every=30.0) -> dict:
    """``runner.consume_fastq`` with a progress line every
    ``progress_every`` seconds (0: none); returns the run's numbers:
    reads streamed (a resumed run's skipped reads excluded), seconds,
    reads/s, the checkpoint offset it resumed from, vote launches,
    escalations and the stats totals."""
    import torch

    from ..kernels.vote import vote_scan_records

    resumed_from = 0
    if checkpoint and os.path.exists(checkpoint + ".json"):
        with open(checkpoint + ".json") as f:
            resumed_from = int(json.load(f)["n_reads"])
    stop = threading.Event()
    if progress_every:
        def progress():
            last_n, last_t = runner.n_reads, time.time()
            while not stop.wait(progress_every):
                n, t = runner.n_reads, time.time()
                log(f"progress: {n} reads total, "
                    f"{(n - last_n) / max(t - last_t, 1e-9):.0f} reads/s "
                    f"over the last {t - last_t:.0f}s")
                last_n, last_t = n, t

        threading.Thread(target=progress, daemon=True).start()
    launches = vote_scan_records.launches
    n0 = runner.n_reads
    t0 = time.perf_counter()
    try:
        runner.consume_fastq(fq, limit_batches=limit_batches or None,
                             checkpoint_path=checkpoint,
                             checkpoint_every=checkpoint_every)
        for d in _devices(runner):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    finally:
        stop.set()
    dt = time.perf_counter() - t0
    reads = runner.n_reads - max(n0, resumed_from)
    return dict(reads=reads, total_reads=runner.n_reads, seconds=dt,
                reads_s=reads / dt, resumed_from=resumed_from,
                vote_launches=vote_scan_records.launches - launches,
                escalations=runner.n_escalations,
                stats={k: int(v) for k, v in runner.stats_totals.items()})


def spot_parity(index, runner, fq, n_spot, seed=11) -> dict:
    """Oracle spot parity at full scale: sample ``n_spot`` reads, stream
    them through the SAME runner (fresh counts), run the sequential oracle
    (fork-parallel) on the identical reads, and compare the saturated
    counts at every site exactly. Returns what it saw; ``mismatches`` is 0
    on a pass."""
    from ..oracle import OracleEngine

    cache_dir = os.path.dirname(fq)
    spot = os.path.join(cache_dir, f"spot_{n_spot}.fq")
    rng = np.random.default_rng(seed)
    with open(fq, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    recs = [lines[i:i + 4] for i in range(0, len(lines) - 3, 4)]
    sel = rng.choice(len(recs), size=min(n_spot, len(recs)), replace=False)
    with open(spot, "wb") as f:
        for i in sorted(sel):
            f.writelines(recs[i])
    del lines, recs
    log(f"spot parity: {len(sel)} reads -> engine")
    t0 = time.perf_counter()
    runner.ref_cnt, runner.alt_cnt = runner._fresh_counts()
    runner.stats_totals = {}
    runner.consume_fastq(spot)
    rc_e, ac_e = runner.host_counts()
    engine_s = time.perf_counter() - t0
    mc = runner.config.max_cov
    s = index.sites
    n = s.pos.shape[0]
    rc_e = np.minimum(rc_e[:n], mc)
    ac_e = np.minimum(ac_e[:n], mc)
    log("spot parity: oracle (fork-parallel)")
    t0 = time.perf_counter()
    eng = OracleEngine(index)
    eng.run_fastq_parallel(spot)
    oracle_s = time.perf_counter() - t0
    rc_o = np.array([eng.pileup[int(p)][4] for p in s.pos], np.int64)
    ac_o = np.array([eng.pileup[int(p)][5] for p in s.pos], np.int64)
    bad = np.flatnonzero((rc_e != rc_o) | (ac_e != ac_o))
    got = dict(reads=len(sel), sites=n, mismatches=int(bad.size),
               increments=int(np.sum(rc_o) + np.sum(ac_o)),
               overflow={k: v for k, v in runner.stats_totals.items()
                         if "overflow" in k and v},
               engine_s=engine_s, oracle_s=oracle_s)
    if bad.size:
        log(f"SPOT PARITY FAIL: {bad.size} sites differ; first "
            f"{[(int(s.pos[i]), int(rc_e[i]), int(rc_o[i]), int(ac_e[i]), int(ac_o[i])) for i in bad[:5]]}")
    else:
        log(f"SPOT PARITY PASS: {len(sel)} reads, {got['increments']} "
            f"site-count increments, 0 mismatches over {n} sites")
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.rehearse_wgs",
        description="genome-scale rehearsal: synthesis, index build, geno")
    ap.add_argument("--mb", type=int, default=3000)
    ap.add_argument("--snps", type=int, default=5_000_000)
    ap.add_argument("--reads", type=int, default=65_536)
    ap.add_argument("--extra-reads", type=int, default=0,
                    help="generate + stream an additional reads_{N}.fq "
                         "from the existing genome/VCF (index untouched)")
    ap.add_argument("--spot-parity", type=int, default=0,
                    help="after geno, verify N sampled reads' counts "
                         "against the sequential oracle spec")
    ap.add_argument("--cache", default=None,
                    help="inputs, index and outputs (default: vgt_wgs in "
                         "the temporary directory)")
    ap.add_argument("--runner", default="sharded", choices=["sharded", "ht"],
                    help="the sharded dictionary (default) or the "
                         "hash-table GenoRunner")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices of the sharded dictionary, "
                         "one shard each (default: --device alone, D = 1)")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--limit-batches", type=int, default=2,
                    help="stop after N batches (0: the whole stream)")
    ap.add_argument("--phase", default="all",
                    choices=["all", "gen", "index", "geno"])
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path prefix (resume-on-restart); "
                         "endurance kill/resume runs use this")
    ap.add_argument("--checkpoint-every", type=int, default=16)
    ap.add_argument("--out", default="out.vcf",
                    help="output VCF filename inside the cache dir")
    ap.add_argument("--progress-every", type=float, default=30.0,
                    help="seconds between progress log lines (0=off)")
    args = ap.parse_args(argv)
    args.cache = args.cache or default_cache()
    devices = args.devices.split(",") if args.devices else [args.device]
    if args.phase in ("all", "geno"):
        import torch

        if any(torch.device(d).type == "cuda" for d in devices) \
                and not torch.cuda.is_available():
            print("error: no CUDA device is available (pass --device cpu to "
                  "run on the host)", file=sys.stderr)
            return 1

    os.makedirs(args.cache, exist_ok=True)
    t0 = time.perf_counter()
    fa, vcf, fq = gen_inputs(args.cache, args.mb, args.snps, args.reads)
    gen_s = time.perf_counter() - t0
    if args.extra_reads:
        fq = gen_extra_reads(args.cache, fa, vcf, args.extra_reads)
    extra_s = time.perf_counter() - t0 - gen_s
    if args.phase == "gen":
        return 0

    prefix = os.path.join(args.cache, "wgs")
    from ..index import store

    if args.phase in ("all", "index") and not store.exists(prefix):
        log("index build: start")
        from ..index.build import build_index

        t0 = time.perf_counter()
        build_index(fa, vcf, prefix)
        build_s = time.perf_counter() - t0
        log("index build: done")
        print(json.dumps({"index": dict(
            mb=args.mb, snps=args.snps, gen_s=gen_s, extra_reads_s=extra_s,
            build_s=build_s,
            disk_bytes=dir_bytes(prefix + ".vgt"),
            peak_rss_bytes=peak_rss())}), flush=True)
    if args.phase == "index":
        return 0

    log("loading index (mmap)")
    t0 = time.perf_counter()
    index = store.load(prefix)
    load_s = time.perf_counter() - t0
    log(f"index loaded: {index.ref.kmers.shape[0]} ref rows, "
        f"{index.snp.kmers.shape[0]} snp rows")

    what = ("hash-table runner on " + args.device if args.runner == "ht"
            else f"sharded-dict runner over {len(devices)} devices "
                 f"{devices}")
    log(f"building {what}")
    t0 = time.perf_counter()
    runner = make_runner(index, geno_config(args.batch), args.runner,
                         args.device, devices)
    setup_s = time.perf_counter() - t0
    log("runner ready; streaming reads")
    got = stream(runner, fq, args.limit_batches, args.checkpoint,
                 args.checkpoint_every, args.progress_every)
    got.update(runner=args.runner, devices=devices, load_s=load_s,
               setup_s=setup_s, index_device_bytes=index_device_bytes(runner),
               peak_device_bytes=peak_device_bytes(runner),
               peak_rss_bytes=peak_rss())
    log(f"geno done: {got['reads']} reads in {got['seconds']:.1f}s "
        f"({got['reads_s']:.0f} reads/s on {', '.join(devices)}), "
        f"stats={runner.stats_totals}, peak device memory "
        f"{got['peak_device_bytes']} B, index {got['index_device_bytes']} B "
        f"on the device")
    out = os.path.join(args.cache, args.out)
    runner.write_vcf(vcf, out)
    with open(out) as f:
        log(f"vcf written: {sum(1 for _ in f)} lines")
    rc = 0
    if args.spot_parity:
        got["spot"] = spot_parity(index, runner, fq, args.spot_parity)
        rc = 1 if got["spot"]["mismatches"] else 0
    print(json.dumps({"geno": got}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
