"""Benchmark: genotyping throughput (reads/s) of the port on one card (port
of the root ``bench.py``, which stays the JAX package's).

    python -m vargeno_tpu_torch.tools.bench [--device cuda|cpu]

Workload: a synthetic 48 Mb (chr22-scale) genome, 500,000 SNPs and 262,144
reads of 101 bp at the reference's error / quality profile (15 % single-base
errors, half the reads reverse-complemented), seed 20260817, streamed through
the port's GenoRunner at batch_reads 32768. Index load and the device
tables are set-up, excluded from the rate. Baseline: the reference binary's
steady-state rate recorded in ``bench_baseline.json`` (8,241 reads/s on its
CPU host; the file is only read).

Environment knobs (defaults in brackets): ``VGT_BENCH_CACHE`` [<tempdir>/
vgt_bench48_torch], ``VGT_BENCH_MB`` [48], ``VGT_BENCH_SNPS`` [500000],
``VGT_BENCH_READS`` [262144], ``VGT_BENCH_BATCH`` [32768],
``VGT_BENCH_PASSES`` [5], ``VGT_BENCH_CLEAN_FRAC`` [0.96],
``VGT_BENCH_MAX_EXTRA`` [6], ``VGT_BENCH_GATHER`` [1; 0 skips the gather
bench and leaves the lane roofline null], ``VGT_BENCH_MODE``,
``VGT_BENCH_GROUP``, ``VGT_BENCH_DEPTH`` [unset; each pins that part of
the dispatch point, and a pin skips the cached calibration: all three pin
one point outright], ``VGT_REF_BINARY`` [/tmp/refbuild/vargeno].

The cache directory holds the dataset (``genome.fa``, ``snps.vcf``,
``reads.fq``, the marker ``ready`` with the workload it was made for), the
index (prefix ``bench``) with its cold build seconds (``ibuild.json``), the
dispatch-mode calibration (``calib.json``), the card's gather rates
(``gather_rates.json``), and after a run the per-site counts of one measured
pass (``bench_counts.npz``: ``ref``, ``alt``; every measured pass must give
the same ones).

Dispatch points (calibrated once per card name, batch and read count, the
winner cached): queued orientation at the right-sized capacities below, the
same with auto-tune -- each at the (group_size, pipeline_depth) pairs
(4, 2), (2, 2), (1, 2), (1, 3) of the JAX bench -- and both orientations
inline (whose loop keeps one batch pending at any depth). All give the
same counts. A point that fails to build or run fails the bench: nothing
falls back to another vote or to the host. A ``calib.json`` without the
pipeline knobs is calibrated anew.

The rate is the median of the clean full passes when at least 3 are
clean, else of every pass. Each pass is bracketed by device-rate probes (pre-encoded batches resident on the card,
dispatched back to back through ``BatchProcessor.single_enc``, one
synchronise at the end); a pass whose probes read below
``VGT_BENCH_CLEAN_FRAC`` of the best probe ran beside another user of the
card and is re-run up to ``VGT_BENCH_MAX_EXTRA`` times. Set-up stages and
every pass go to stderr; the last line of stdout is one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, GenoConfig

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASELINE_FILE = os.path.join(REPO, "bench_baseline.json")
READ_LEN = 101      # the reference's READ_LEN (vartype.h:16)
SEED = 20260817
ERR_FRAC = 0.15
INDEX_NAME = "bench"
# dispatch modes, in calibration order; the first is the default
MODES = ("queued", "queued_tuned", "inline_dual")
# (group_size, pipeline_depth) pairs calibrated for the queued modes (the
# JAX bench's candidates)
PIPELINES = ((4, 2), (2, 2), (1, 2), (1, 3))
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"# [{time.perf_counter() - T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


@contextlib.contextmanager
def stage(name: str):
    """A set-up stage: its seconds on a stderr line."""
    t0 = time.perf_counter()
    yield
    log(f"stage {name}: {time.perf_counter() - t0:.2f} s")


@dataclasses.dataclass(frozen=True)
class Workload:
    cache: str
    mb: float = 48
    snps: int = 500_000
    reads: int = 262_144
    batch: int = 32768
    passes: int = 5

    @classmethod
    def from_env(cls) -> "Workload":
        env = os.environ.get
        return cls(cache=env("VGT_BENCH_CACHE", os.path.join(
                       tempfile.gettempdir(), "vgt_bench48_torch")),
                   mb=float(env("VGT_BENCH_MB", 48)),
                   snps=int(env("VGT_BENCH_SNPS", 500_000)),
                   reads=int(env("VGT_BENCH_READS", 262_144)),
                   batch=int(env("VGT_BENCH_BATCH", 32768)),
                   passes=int(env("VGT_BENCH_PASSES", 5)))

    def path(self, name: str) -> str:
        return os.path.join(self.cache, name)

    @property
    def fa(self) -> str:
        return self.path("genome.fa")

    @property
    def vcf(self) -> str:
        return self.path("snps.vcf")

    @property
    def fq(self) -> str:
        return self.path("reads.fq")

    @property
    def prefix(self) -> str:
        return self.path(INDEX_NAME)

    def dataset_key(self) -> dict:
        return dict(mb=self.mb, snps=self.snps, reads=self.reads,
                    read_len=READ_LEN, err_frac=ERR_FRAC, seed=SEED)


def build_dataset(wl: Workload):
    """The workload's FASTA, VCF and FASTQ, made once per cache directory
    (the marker names the workload; a cache made for another one is an
    error, not a silent reuse)."""
    os.makedirs(wl.cache, exist_ok=True)
    marker = wl.path("ready")
    if os.path.exists(marker):
        with open(marker) as f:
            got = json.load(f)
        if got != wl.dataset_key():
            raise ValueError(f"{wl.cache} holds the dataset {got}, not "
                             f"{wl.dataset_key()}: set VGT_BENCH_CACHE to "
                             f"another directory")
        return wl.fa, wl.vcf, wl.fq
    from ..testing import synth_genome, write_inputs

    rng = np.random.default_rng(SEED)
    genome = synth_genome(rng, sizes=(round(wl.mb * 1_000_000),),
                          names=("chrB1",))
    write_inputs(wl.cache, rng, genome, n_snps=wl.snps, n_reads=wl.reads,
                 read_len=READ_LEN, err_frac=ERR_FRAC)
    with open(marker, "w") as f:
        json.dump(wl.dataset_key(), f)
    return wl.fa, wl.vcf, wl.fq


def build_index(wl: Workload, config: GenoConfig = DEFAULT_CONFIG):
    """The workload's index: loaded when the cache holds it, else built
    (its cold seconds recorded in ``ibuild.json``, the index_build metric).
    ``config`` sets the Bloom geometry of a build (the reference's by
    default)."""
    from ..index import store
    from ..index.build import build_index as bi

    if store.exists(wl.prefix):
        return store.load(wl.prefix)
    t0 = time.perf_counter()
    idx = bi(wl.fa, wl.vcf, wl.prefix, config)
    with open(wl.path("ibuild.json"), "w") as f:
        json.dump({"index_build_s": round(time.perf_counter() - t0, 2)}, f)
    return idx


def load_index(wl: Workload):
    """The workload's index as the bench left it in the cache (the
    companion tools build nothing)."""
    from ..index import store

    if not store.exists(wl.prefix):
        raise FileNotFoundError(f"no bench index at {wl.prefix}: run "
                                f"python -m vargeno_tpu_torch.tools.bench "
                                f"once first")
    return store.load(wl.prefix)


def no_card(device) -> bool:
    """True, with the error printed, when ``device`` is CUDA and no card
    is visible (a tool then exits 1; the host runs only when asked)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is available (pass --device cpu to "
              "run on the host)", file=sys.stderr)
        return True
    return False


def ref_binary() -> str:
    return os.environ.get("VGT_REF_BINARY", "/tmp/refbuild/vargeno")


def measure_reference(wl: Workload) -> float:
    """reads/s of the reference binary, set-up excluded: the repo's
    recorded ``bench_baseline.json``; without it a measurement cached in
    the dataset directory, or one made now when the binary exists (written
    there, never into the repo); NaN when neither."""
    for path in (BASELINE_FILE, wl.path("ref_baseline.json")):
        if os.path.exists(path):
            with open(path) as f:
                got = json.load(f).get("ref_reads_per_sec")
            if got:
                return got
    binary = ref_binary()
    if not os.path.exists(binary):
        return float("nan")
    prefix = wl.path("refidx")
    if not os.path.exists(prefix + ".ref.dict"):
        subprocess.run([binary, "index", wl.fa, wl.vcf, prefix], check=True,
                       stdout=subprocess.DEVNULL)
    # an empty-read run isolates set-up (jumpgate init, dict load)
    empty = wl.path("empty.fq")
    open(empty, "w").close()
    out = wl.path("ref_out.vcf")

    def timed(reads_file):
        t0 = time.perf_counter()
        subprocess.run([binary, "geno", prefix, reads_file, wl.vcf, out],
                       check=True, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)
        return time.perf_counter() - t0

    timed(empty)            # cold: page the dictionaries in
    t_setup = timed(empty)
    t_full = timed(wl.fq)
    rate = wl.reads / max(t_full - t_setup, 1e-3)
    update_json(wl.path("ref_baseline.json"),
                 {"ref_reads_per_sec": rate, "n_reads": wl.reads,
                  "t_setup": t_setup, "t_full": t_full})
    return rate


def ref_index_build_s():
    """The reference binary's recorded cold index-build seconds on the
    bench dataset (``bench_baseline.json``), or None."""
    if not os.path.exists(BASELINE_FILE):
        return None
    with open(BASELINE_FILE) as f:
        return json.load(f).get("ref_index_build_s")


def update_json(path: str, upd: dict) -> None:
    got = {}
    if os.path.exists(path):
        with open(path) as f:
            got = json.load(f)
    got.update(upd)
    with open(path, "w") as f:
        json.dump(got, f)


def bench_config(wl: Workload) -> GenoConfig:
    """bench.py's configuration: kmer slots and padded length from the read
    length, and capacities right-sized to the per-step maxima measured on
    this workload (1.15-4 x headroom each; overflow escalation restores
    exactness if one ever trips)."""
    return GenoConfig(batch_reads=wl.batch,
                      max_read_len=max(128, -(-READ_LEN // 32) * 32),
                      # the reference ignores the sub-32 read tail
                      # (qv.cc:779): floor(len/32) kmer slots
                      max_kmers_per_read=READ_LEN // 32,
                      ht_target_load=0.24,
                      neighbor_item_frac=0.0834,   # NI 8192
                      probe_active_frac=0.25,      # NC 131,072
                      events_per_read=16,          # ev_max 4
                      scan_active_frac=0.15,       # scan lanes 3137 / 5713
                      probe_hit_cap=6)             # probe lanes 4103


@dataclasses.dataclass(frozen=True)
class Point:
    """A dispatch point: the mode and the host pipeline's knobs."""

    mode: str
    group_size: int = 1
    pipeline_depth: int = DEFAULT_CONFIG.pipeline_depth

    def __str__(self) -> str:
        return f"{self.mode} G={self.group_size} depth={self.pipeline_depth}"


def points(mode: str | None = None, group: int | None = None,
           depth: int | None = None) -> list:
    """The calibration candidates, in order, with the pins applied: every
    queued mode at each PIPELINES pair, inline dual at group 1. A pinned
    group other than 1 leaves inline dual out."""
    out = []
    for m in MODES:
        if mode is not None and m != mode:
            continue
        if m == "inline_dual":
            if group not in (None, 1):
                continue
            pairs = ((1, DEFAULT_CONFIG.pipeline_depth),)
        else:
            pairs = PIPELINES
        for g, d in pairs:
            p = Point(m, g if group is None else group,
                      d if depth is None else depth)
            if p not in out:
                out.append(p)
    if not out:
        raise ValueError(f"no dispatch point fits the pins mode={mode} "
                         f"group={group} depth={depth}")
    return out


def pinned_points() -> list | None:
    """The candidates the VGT_BENCH_MODE / _GROUP / _DEPTH pins leave, or
    None when nothing is pinned."""
    env = os.environ.get
    mode, group, depth = (env("VGT_BENCH_MODE"), env("VGT_BENCH_GROUP"),
                          env("VGT_BENCH_DEPTH"))
    if mode is None and group is None and depth is None:
        return None
    return points(mode, None if group is None else int(group),
                  None if depth is None else int(depth))


def make_runner(index, dix, wl: Workload, mode: str, device,
                group_size: int = 1,
                pipeline_depth: int = DEFAULT_CONFIG.pipeline_depth):
    """A GenoRunner of one dispatch point over the shared device index."""
    from ..engine.geno import GenoRunner

    if mode not in MODES:
        raise ValueError(f"unknown dispatch mode {mode!r}; one of {MODES}")
    cfg = dataclasses.replace(bench_config(wl), group_size=group_size,
                              pipeline_depth=pipeline_depth)
    if mode == "queued_tuned":
        cfg = dataclasses.replace(cfg, auto_tune=True)
    return GenoRunner(index, cfg, device=device, dix=dix,
                      queued_orientation=mode != "inline_dual")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_pass(runner, fq: str) -> float:
    """reads/s of one full pass from fresh counts, ending in a device
    synchronise."""
    runner.ref_cnt, runner.alt_cnt = runner._fresh_counts()
    sync(runner.device)
    t0 = time.perf_counter()
    n0 = runner.n_reads
    runner.consume_fastq(fq)
    sync(runner.device)
    return (runner.n_reads - n0) / (time.perf_counter() - t0)


def resident_sets(runner, fq: str, nb: int = 6) -> list:
    """``nb`` pre-encoded batches resident on the runner's device (the
    device-rate probe's working set; built once, reused by every probe)."""
    from ..engine.geno import _encoder, upload
    from ..io.fastq import iter_read_batches

    cfg = runner.config
    encode = _encoder(cfg.max_kmers_per_read)
    sets = [upload(runner.device, encode(b.codes, b.n_kmers), b.qual)
            for b in itertools.islice(iter_read_batches(
                fq, cfg.batch_reads, cfg.max_read_len,
                cfg.max_kmers_per_read), nb)]
    sync(runner.device)
    return sets


def device_pass(runner, sets: list, reps: int = 1) -> float:
    """Steady-state device-step rate: the resident batches dispatched back
    to back through ``single_enc`` (the runner's current configuration),
    one synchronise at the end; the best of ``reps``. No host parse,
    encode or retry queue is in it: it moves when the step changes or when
    another process uses the card, which makes it the bench's contention
    detector. Where the step is bound by its host issue time (eager
    PyTorch on a GPU) it moves with the host's load as well."""
    cfg = runner.config
    proc = runner._proc(runner._cfg_run)
    best = 0.0
    for _ in range(reps):
        z, z2 = runner._fresh_counts()
        sync(runner.device)
        t0 = time.perf_counter()
        for args in sets:
            z, z2 = proc.single_enc(*args, z, z2)[:2]
        sync(runner.device)
        best = max(best, len(sets) * cfg.batch_reads
                   / (time.perf_counter() - t0))
    return best


@dataclasses.dataclass
class Pick:
    rate: float
    point: Point
    runner: object

    @property
    def mode(self) -> str:
        return self.point.mode


def cached_point(calib_file: str, key: str):
    """(point, calibration record) cached for ``key``, or (None, None): an
    older file without the pipeline knobs counts as no calibration."""
    if not os.path.exists(calib_file):
        return None, None
    with open(calib_file) as f:
        got = json.load(f)
    if (got.get("key") != key or got.get("mode") not in MODES
            or not isinstance(got.get("group_size"), int)
            or not isinstance(got.get("pipeline_depth"), int)):
        return None, None
    return Point(got["mode"], got["group_size"], got["pipeline_depth"]), got


def calibrate(make, time_pass, probe, calib_file: str, key: str,
              forced: list | None = None) -> Pick:
    """Choose the dispatch point. ``make(point)`` builds and warms a
    runner, ``time_pass(runner)`` gives reads/s of one pass,
    ``probe(runner)`` the device rate. ``forced``: the candidates the pins
    leave (``pinned_points``), timed whatever the cache holds. Else the
    cached winner for ``key`` is timed alone, or every point when there is
    none. A rate under half the running best is re-timed once and the
    larger kept (one-off transients would otherwise be cached). A cached
    winner running under 0.7 x its recorded rate is re-calibrated, unless
    a device probe under 0.85 x its recorded device rate says the card is
    shared right now: then the cached choice stays and the file is left
    alone. Any failure raises."""
    cached, cal = cached_point(calib_file, key)
    if forced is not None:
        cand = list(forced)
    elif cached is not None:
        cand = [cached]
    else:
        cand = points()

    def measure(cands, best=None):
        for point in cands:
            runner = make(point)
            rate = time_pass(runner)
            if best is not None and rate < 0.5 * best.rate:
                rate2 = time_pass(runner)
                log(f"calib outlier re-check {point}: {rate:.0f} -> "
                    f"{rate2:.0f}")
                rate = max(rate, rate2)
            log(f"calib {point}: {rate:.0f} reads/s")
            if best is None or rate > best.rate:
                best = Pick(rate, point, runner)
        return best

    best = measure(cand)
    if (cal is not None and forced is None
            and best.rate < 0.7 * cal.get("calib_rate", 0)):
        rec_dr = cal.get("device_rate")
        dr = probe(best.runner) if rec_dr else None
        if dr is not None and dr < 0.85 * rec_dr:
            log(f"cached winner {best.rate:.0f} << recorded "
                f"{cal['calib_rate']:.0f}, but device probe {dr:.0f} << "
                f"recorded {rec_dr:.0f}: the card is shared -- keeping the "
                f"cached calibration")
            return best
        log(f"cached winner {best.rate:.0f} << recorded "
            f"{cal['calib_rate']:.0f}; re-calibrating")
        best = measure([p for p in points() if p != best.point], best)
    dr0 = probe(best.runner)
    with open(calib_file, "w") as f:
        json.dump({"key": key, "mode": best.point.mode,
                   "group_size": best.point.group_size,
                   "pipeline_depth": best.point.pipeline_depth,
                   "calib_rate": round(best.rate, 1),
                   "device_rate": round(dr0, 1)}, f)
    return best


def device_kind(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(r.stdout.strip().splitlines())


def device_label(device) -> str:
    """What a result names as its device: the card's name and power limit,
    or ``cpu`` for a host run."""
    return card_line() if torch.device(device).type == "cuda" else "cpu"


def pick_runner(index, wl: Workload, device):
    """Build the device index once, then the measurement runner of the
    calibrated dispatch point. Returns (runner, point)."""
    from ..engine.device_index import build_device_index

    with stage("device tables"):
        dix = build_device_index(index, device,
                                 bench_config(wl).ht_target_load)
        sync(device)

    def make(point):
        runner = make_runner(index, dix, wl, point.mode, device,
                             point.group_size, point.pipeline_depth)
        # warm (a group dispatches from its G-th batch)
        runner.consume_fastq(wl.fq, limit_batches=2 * point.group_size)
        return runner

    def probe(runner):
        return device_pass(runner, resident_sets(runner, wl.fq, nb=4),
                           reps=2)

    key = f"{device_kind(device)}|{wl.batch}|{wl.reads}"
    with stage("calibrate (warm + one pass a point)"):
        best = calibrate(make, lambda r: timed_pass(r, wl.fq), probe,
                         wl.path("calib.json"), key,
                         forced=pinned_points())
    return best.runner, best.point


def gather_rates(wl: Workload, device):
    """The card's measured random-gather lane rates for the lane roofline
    (``tools.bench_gather`` in a process of its own, cached per device name
    in the dataset directory); None with ``VGT_BENCH_GATHER=0``."""
    path = wl.path("gather_rates.json")
    kind = device_kind(device)
    if os.path.exists(path):
        with open(path) as f:
            got = json.load(f)
        if got.get("device") == kind:
            return got
    if os.environ.get("VGT_BENCH_GATHER", "1") == "0":
        return None
    r = subprocess.run([sys.executable, "-m",
                        "vargeno_tpu_torch.tools.bench_gather", "--device",
                        str(device)], cwd=REPO, capture_output=True,
                       text=True, timeout=600, check=True)
    got = json.loads(r.stdout.strip().splitlines()[-1])
    with open(path, "w") as f:
        json.dump(got, f)
    return got


def retry_frac(runner) -> float:
    """Reverse-orientation dispatches a read, the device work beyond one
    forward pass: the measured retry fraction of a queued runner, 1 for the
    inline dual step (every read runs both orientations)."""
    if not runner.queued:
        return 1.0
    return runner.n_retry_reads / max(runner.n_reads, 1)


def roofline_report(runner, rate: float, rates) -> dict:
    """The roofline of the pass: the configuration it ran, its measured
    low-quality and retry fractions, the card's gather rates."""
    from ..utils.roofline import roofline

    cfg = runner._cfg_run
    st = runner.stats_totals
    lanes = max(runner.n_reads * cfg.max_kmers_per_read, 1)
    # low-quality k-mers of every orientation pass (the dual step's stats
    # carry fwd_ / rev_ prefixes)
    lowq = sum(v for k, v in st.items() if k.endswith("lowq_n"))
    return roofline(cfg, runner.dix, device_kind(runner.device),
                    cfg.batch_reads, rate,
                    lowq_frac=min(lowq / lanes, 1.0),
                    retry_frac=retry_frac(runner), gather_rates=rates)


def run(wl: Workload, device) -> dict:
    """The whole bench; returns the result line (also writes
    ``bench_counts.npz``)."""
    from ..kernels.vote import vote_scan_records

    device = torch.device(device)
    on_cuda = device.type == "cuda"
    with stage("dataset"):
        build_dataset(wl)
    ref_rate = measure_reference(wl)
    with stage("index (load, or build when the cache has none)"):
        index = build_index(wl)
    runner, point = pick_runner(index, wl, device)
    log(f"dispatch point {point}")

    clean_frac = float(os.environ.get("VGT_BENCH_CLEAN_FRAC", 0.96))
    max_extra = int(os.environ.get("VGT_BENCH_MAX_EXTRA", 6))
    with stage("device probe working set + first probe"):
        sets = resident_sets(runner, wl.fq)
        probe0 = device_pass(runner, sets, reps=2)

    passes = []   # (rate, probe before, probe after)
    best_probe = probe0
    want = None
    launches = 0

    def one_pass(prev_probe):
        nonlocal best_probe, want, launches
        l0 = vote_scan_records.launches
        t0 = time.perf_counter()
        r = timed_pass(runner, wl.fq)
        dt = time.perf_counter() - t0
        n = vote_scan_records.launches - l0
        launches += n
        # two reps, best of: one probe of six batches jitters ~3 % where
        # the step is device-bound, right at the clean / shared bar
        pr = device_pass(runner, sets, reps=2)
        best_probe = max(best_probe, pr)
        passes.append((r, prev_probe, pr))
        got = runner.host_counts()
        if want is None:
            want = got
        elif not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"pass {len(passes)} counts differ from "
                                 f"the first measured pass's")
        log(f"pass {len(passes)}: {r:.0f} reads/s ({dt:.3f} s, vote "
            f"launches {n}), probe after {pr:.0f}")
        return pr

    def clean(p):
        return min(p[1], p[2]) >= clean_frac * best_probe

    with stage("rate (passes)"):
        prev = probe0
        for _ in range(wl.passes):
            prev = one_pass(prev)
        extra = 0
        while sum(map(clean, passes)) < wl.passes and extra < max_extra:
            extra += 1
            prev = one_pass(prev)
    rates = [p[0] for p in passes]
    cl = [p[0] for p in passes if clean(p)]
    pool = cl if len(cl) >= 3 else rates
    rate = sorted(pool)[len(pool) // 2]
    for r, pb, pa in passes:
        log(f"pass {r:8.0f} reads/s  probes [{pb:.0f}, {pa:.0f}] (best "
            f"{best_probe:.0f}) -> "
            f"{'clean' if clean((r, pb, pa)) else 'SHARED'}")
    log(f"pass rates: {[round(r) for r in rates]} (median of {len(pool)} "
        f"{'clean ' if pool is cl else ''}passes)")
    ovf = {k: v for k, v in runner.stats_totals.items()
           if "overflow" in k and v}
    if ovf:
        raise AssertionError(f"overflow counters left after escalation: "
                             f"{ovf}")
    np.savez(wl.path("bench_counts.npz"), ref=want[0], alt=want[1])

    vs = rate / ref_rate if ref_rate == ref_rate else None
    line = {
        "metric": "geno_throughput",
        "value": round(rate, 1),
        "unit": "reads/sec/chip" if on_cuda else "reads/sec/cpu",
        "vs_baseline": round(vs, 3) if vs is not None else None,
        "passes_clean": len(cl),
        "passes_total": len(passes),
        "pass_spread": round((max(pool) - min(pool)) / rate, 3),
        # the best probe is the cleanest observation of the step itself
        "device_rate": round(best_probe, 1),
        "retry_frac": round(retry_frac(runner), 3),
        "mode": point.mode,
        "group_size": point.group_size,
        "pipeline_depth": point.pipeline_depth,
    }
    log(f"device_rate: {line['device_rate']} reads/s (retry_frac "
        f"{line['retry_frac']})")
    ib_path = wl.path("ibuild.json")
    line["index_build_s"] = line["index_build_vs"] = None
    if os.path.exists(ib_path):   # absent when the index came from elsewhere
        with open(ib_path) as f:
            line["index_build_s"] = json.load(f)["index_build_s"]
        rb = ref_index_build_s()
        if rb:
            line["index_build_vs"] = round(rb / line["index_build_s"], 2)
    log(f"index_build: {line['index_build_s']} s "
        f"({line['index_build_vs']} x the reference binary)")
    rep = roofline_report(runner, rate, gather_rates(wl, device))
    log(f"roofline: {json.dumps(rep)}")
    line["lane_roofline_frac"] = rep["lane_roofline_frac"]
    line["bw_roofline_frac"] = rep["bw_roofline_frac"]
    with open(wl.path("calib.json")) as f:
        log(f"calibration: {f.read()}")
    line["device"] = device_label(device)
    line["vote_launches"] = launches
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.bench",
        description="genotyping reads/s of the port on one card")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    if no_card(args.device):
        return 1
    print(json.dumps(run(Workload.from_env(), args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
