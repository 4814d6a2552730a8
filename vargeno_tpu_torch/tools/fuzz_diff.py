"""Differential fuzzing (port of ``tools/fuzz_diff.py``): the batched engine
against the sequential oracle on freshly synthesized fixtures. Any count
mismatch is a correctness bug (the oracle is the executable spec, itself
pinned byte-identical to the compiled reference binary on
tests/fixtures/mini).

    python -m vargeno_tpu_torch.tools.fuzz_diff [n_seeds] [start_seed]
        [--device cuda|cpu]

Sweeps genome size, read counts, error rate and capacity pressure across
seeds; seed N draws the same case as the JAX tool's seed N. Prints
PASS/FAIL per seed; exits nonzero on any failure. The engine runs on the
card unless ``--device cpu`` is asked for; with no card the tool stops.

Env: VGT_FUZZ_BIG=1 scales every seed up ~100x (10^5-10^6 reads, larger
genomes) -- the oracle side runs fork-parallel so a big seed stays in
minutes; use for release-level shakes of engine changes.

``run_seed(seed, device, make_runner=...)`` runs a seed's case through any
runner: ``make_runner(index, config, device, queued)`` returns an object
with ``consume_fastq``, ``host_counts``, ``stats_totals`` and
``n_escalations`` (GenoRunner by default; ``mesh_runner`` makes one for
the mesh runners). ``prepare`` + ``check`` split it, so that one fixture
and one oracle run serve several runners.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import GenoConfig
from ..dist.sharding import make_mesh
from ..engine.geno import GenoRunner
from ..index import store
from ..kernels.vote import vote_scan_records
from ..oracle import OracleEngine
from ..testing import make_synthetic

MAX_COV = 63          # the oracle's saturating 6-bit counters
PARALLEL_ORACLE = 20_000   # reads from which the oracle runs fork-parallel


def big_scale() -> bool:
    return os.environ.get("VGT_FUZZ_BIG", "0") == "1"


def draw_case(seed: int, big: bool | None = None) -> dict:
    """The case of ``seed`` as ``tools/fuzz_diff.py`` draws it: the
    fixture's ``make_synthetic`` arguments (``synth``), the engine's
    GenoConfig fields (``config``) and the orientation mode (``queued``).
    The JAX tool also draws group_size, pipeline_depth and
    sparse_exact_snp, which the port's GenoConfig lacks: they are drawn in
    their place and kept apart (``dropped``), so that seed N is the same
    case in both tools."""
    rng = np.random.default_rng(seed ^ 0xF00D)
    big = big_scale() if big is None else big
    scale = 100 if big else 1
    sizes = tuple(int(rng.integers(6_000, 40_000)) * (10 if big else 1)
                  for _ in range(int(rng.integers(1, 3))))
    names = tuple(f"chr{i}" for i in range(len(sizes)))
    n_snps = int(rng.integers(10, 200)) * scale
    n_reads = int(rng.integers(200, 1500)) * (1000 if big else 1)
    err = float(rng.choice([0.0, 0.1, 0.3, 0.6]))
    batch_reads = int(rng.choice([64, 256, 509]))
    dropped = dict(group_size=int(rng.choice([1, 3])),
                   pipeline_depth=int(rng.choice([1, 2])),
                   sparse_exact_snp=bool(rng.integers(0, 2)))
    config = dict(batch_reads=batch_reads, max_read_len=128,
                  max_kmers_per_read=4,
                  # low caps exercise the auto-retry escalation path
                  events_per_read=int(rng.choice([16, 96])),
                  agree_cap=int(rng.choice([2, 4])))
    return dict(seed=seed, synth=dict(sizes=sizes, names=names,
                                      n_snps=n_snps, n_reads=n_reads,
                                      err_frac=err),
                config=config, dropped=dropped,
                queued=bool(rng.integers(0, 2)))


def describe(case: dict) -> str:
    s, c = case["synth"], case["config"]
    return (f"sizes={s['sizes']} snps={s['n_snps']} reads={s['n_reads']} "
            f"err={s['err_frac']} B={c['batch_reads']} "
            f"E={c['events_per_read']} agree={c['agree_cap']} "
            f"queued={case['queued']}")


@dataclasses.dataclass
class Prepared:
    """A seed's fixture and the oracle's counts over it."""

    case: dict
    index: store.VarGenoIndex
    vcf: str
    fq: str
    orc_ref: np.ndarray   # (n_sites,) at each site, saturated at MAX_COV
    orc_alt: np.ndarray
    oracle_s: float


def prepare(seed: int, tmpdir: str, big: bool | None = None) -> Prepared:
    """Draw ``seed``'s case, write its fixture into ``tmpdir`` and run the
    sequential oracle over it (fork-parallel from 20,000 reads). It does no
    torch work; run it before a process starts work on the card, since
    the parallel oracle forks."""
    case = draw_case(seed, big)
    index, _, vcf, fq = make_synthetic(seed=seed, tmpdir=str(tmpdir),
                                       **case["synth"])
    t0 = time.perf_counter()
    oracle = OracleEngine(index)
    if case["synth"]["n_reads"] >= PARALLEL_ORACLE:
        oracle.run_fastq_parallel(fq)
    else:
        oracle.run_fastq(fq)
    pos = index.sites.pos
    orc_ref = np.array([oracle.pileup[int(p)][4] for p in pos], np.int64)
    orc_alt = np.array([oracle.pileup[int(p)][5] for p in pos], np.int64)
    return Prepared(case, index, vcf, fq, orc_ref, orc_alt,
                    time.perf_counter() - t0)


def say(msg: str) -> None:
    print(msg, flush=True)


def geno_runner(index, config, device, queued):
    return GenoRunner(index, config, device=device,
                      queued_orientation=queued)


def mesh_runner(cls, D: int):
    """A ``make_runner`` for the mesh runner class ``cls``
    (ShardedGenoRunner, ShardedDictGenoRunner) on D shards, every one on
    the device ``check`` is given (a device named D times: a check of the
    routing and the lockstep, not a deployment)."""
    def make(index, config, device, queued):
        return cls(index, make_mesh(devices=[device] * D), config,
                   queued_orientation=queued)
    return make


def bad_sites(prep: Prepared, rc, ac) -> list:
    """One line for each site where ``min(count, 63)`` of the engine's
    counts ``rc`` / ``ac`` (unsaturated, a slot or more past the sites)
    differs from the oracle's."""
    n = prep.orc_ref.shape[0]
    # engine counts are unsaturated; the oracle saturates at max_cov
    eng_ref = np.minimum(np.asarray(rc)[:n].astype(np.int64), MAX_COV)
    eng_alt = np.minimum(np.asarray(ac)[:n].astype(np.int64), MAX_COV)
    orc_ref = np.minimum(prep.orc_ref, MAX_COV)
    orc_alt = np.minimum(prep.orc_alt, MAX_COV)
    pos = prep.index.sites.pos
    return [f"  site {i} pos={pos[i]} engine=({eng_ref[i]},{eng_alt[i]}) "
            f"oracle=({orc_ref[i]},{orc_alt[i]})"
            for i in np.flatnonzero((eng_ref != orc_ref)
                                    | (eng_alt != orc_alt))]


def check(prep: Prepared, device: str = "cuda", make_runner=geno_runner,
          say=say) -> dict:
    """Run ``prep``'s reads through ``make_runner(index, config, device,
    queued)`` and hold ``min(count, 63)`` at every site against the
    oracle's. Prints the seed's PASS / FAIL line, and the first ten bad
    sites on a mismatch; returns what it saw."""
    case = prep.case
    launches = vote_scan_records.launches
    t0 = time.perf_counter()
    runner = make_runner(prep.index, GenoConfig(**case["config"]), device,
                         case["queued"])
    runner.consume_fastq(prep.fq)
    bad = bad_sites(prep, *runner.host_counts())
    engine_s = time.perf_counter() - t0
    got = dict(
        seed=case["seed"], ok=not bad, mismatches=len(bad),
        sites=int(prep.orc_ref.shape[0]), reads=int(runner.n_reads),
        escalations=int(runner.n_escalations),
        vote_launches=vote_scan_records.launches - launches,
        overflow={k: int(v) for k, v in runner.stats_totals.items()
                  if "overflow" in k and v},
        engine_s=engine_s, oracle_s=prep.oracle_s)
    say(f"seed {case['seed']}: {'PASS' if got['ok'] else 'FAIL'} "
        f"({engine_s + prep.oracle_s:.1f}s engine+oracle) {describe(case)} "
        f"mismatches={got['mismatches']} escalations={got['escalations']} "
        f"vote_launches={got['vote_launches']} "
        f"overflow_left={got['overflow'] or 0}")
    for line in bad[:10]:
        say(line)
    return got


def run_seed(seed: int, device: str = "cuda", make_runner=geno_runner,
             tmpdir: str | None = None) -> dict:
    """``prepare`` then ``check`` one seed; the fixture goes to ``tmpdir``,
    or to a temporary directory removed afterwards."""
    if tmpdir is not None:
        return check(prepare(seed, tmpdir), device, make_runner)
    with tempfile.TemporaryDirectory(prefix="vgt_fuzz_") as d:
        return check(prepare(seed, d), device, make_runner)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.fuzz_diff",
        description="differential fuzzing: the engine against the "
                    "sequential oracle on synthesized fixtures")
    ap.add_argument("n_seeds", nargs="?", type=int, default=10)
    ap.add_argument("start_seed", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("error: no CUDA device is available (pass --device cpu to "
              "run on the host)", file=sys.stderr)
        return 1
    n, fails = args.n_seeds, 0
    for seed in range(args.start_seed, args.start_seed + n):
        try:
            if not run_seed(seed, args.device)["ok"]:
                fails += 1
        except Exception as e:  # noqa: BLE001 - report and continue
            import traceback

            traceback.print_exc()
            print(f"seed {seed}: ERROR {e!r}", flush=True)
            fails += 1
    print(f"{n - fails}/{n} passed", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
