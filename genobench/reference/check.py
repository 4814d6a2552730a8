"""The comparison that decides ``correct``: the reference, run on the
cell's own inputs, against what the timed samples produced.

The reference rebuilds its index from the FASTA and VCF, draws a sample
of sites from the seed, runs its oracle over every read that can touch
them (``select``), and calls them. Two numbers are compared, each against
a limit of 0 (the comparisons are exact):

- ``vcf_sites``: over every timed sample's output VCF, the sampled sites
  whose row differs from the reference's (a row missing on one side
  counts);
- ``count_sites``: the sampled sites whose (REF, ALT) pileup counts in the
  program's state after the last sample differ from the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np

from . import calls, index, oracle, select

LIMITS = {"vcf_sites": 0, "count_sites": 0}
N_SITES = 4096    # sites a run checks, drawn from its seed


@dataclasses.dataclass
class Reference:
    sites: np.ndarray        # sampled site positions, ascending
    counts: np.ndarray       # (n, 2) REF / ALT counts
    lines: list              # expected output row per site, None uncalled
    keys: dict               # (chrom, 1-based pos) -> site's index
    reads: int               # reads the oracle ran
    seconds: dict


@dataclasses.dataclass
class Prepared:
    ix: index.Index
    sites: np.ndarray
    seqs: np.ndarray
    quals: np.ndarray
    chosen: np.ndarray       # reads that can touch a sampled site
    seconds: dict


def prepare(fasta: str, vcf: str, fastq: str, ref_bf_bits: int,
            snp_bf_bits: int, n_sites: int, seed: int) -> Prepared:
    """The reference's index, the sampled sites and the reads to run."""
    t0 = time.perf_counter()
    ix = index.build(fasta, vcf, ref_bf_bits, snp_bf_bits)
    t1 = time.perf_counter()
    sites = select.sample_sites(ix, n_sites, seed)
    keys = select.Keys(ix, sites)
    seqs, quals = select.fastq_records(fastq)
    chosen = np.zeros(seqs.shape[0], bool)
    step = 1 << 18
    for s in range(0, seqs.shape[0], step):
        km, low = select.read_kmers(seqs[s:s + step], quals[s:s + step])
        chosen[s:s + step] = keys.reads(km, low)
    return Prepared(ix, sites, seqs, quals, chosen,
                    {"index": t1 - t0, "select": time.perf_counter() - t1})


def reference(p: Prepared, neighbors: bool = True,
              dtype=np.float64) -> Reference:
    """The oracle over the chosen reads, and the sampled sites' calls."""
    t0 = time.perf_counter()
    ix, sites = p.ix, p.sites
    orc = oracle.Oracle(ix, neighbors=neighbors)
    for i in np.flatnonzero(p.chosen):
        orc.process_read(p.seqs[i].tobytes().decode(),
                         p.quals[i].tobytes().decode())
    counts = orc.counts(sites)
    at = np.searchsorted(ix.site_pos, sites)
    rf, af = ix.site_rf[at], ix.site_af[at]
    rows = [ix.snps[int(q)].line for q in sites]
    chrom_of = {c.start: c.name for c in ix.chroms}
    starts = np.array(sorted(chrom_of))
    keys = {}
    for j, q in enumerate(sites.tolist()):
        st = int(starts[np.searchsorted(starts, q, "right") - 1])
        keys[(chrom_of[st], q - st + 1)] = j
    return Reference(sites=sites, counts=counts,
                     lines=calls.lines(rows, counts, rf, af, dtype), keys=keys,
                     reads=int(p.chosen.sum()),
                     seconds=dict(p.seconds,
                                  oracle=time.perf_counter() - t0))


def run(fasta: str, vcf: str, fastq: str, ref_bf_bits: int,
        snp_bf_bits: int, n_sites: int, seed: int) -> Reference:
    return reference(prepare(fasta, vcf, fastq, ref_bf_bits, snp_bf_bits,
                             n_sites, seed))


def compare(ref: Reference, other: Reference) -> dict:
    """The compared numbers of ``other`` (the control, in the program's
    place) against the reference."""
    return {"vcf_sites": sum(a != b for a, b in zip(other.lines, ref.lines)),
            "count_sites": int((other.counts != ref.counts).any(1).sum())}


def vcf_rows(path: str, keys: dict) -> list:
    """The row at each sampled site of an output VCF (None where absent),
    in the order of ``keys``' values."""
    out = [None] * len(keys)
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            c = line.split("\t", 2)
            j = keys.get((c[0], int(c[1])))
            if j is not None:
                out[j] = line.rstrip("\n")
    return out


def digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def judge(ref: Reference, vcfs: list, counts: dict | None) -> dict:
    """The compared numbers: ``vcfs`` are the timed samples' output paths
    (None for a sample that wrote none: all its sites count), ``counts``
    maps a site position to the program's (REF, ALT) after the last
    sample (None when there is no program state: every site counts)."""
    bad_rows = 0
    seen = {}
    for path in vcfs:
        if path is None:
            bad_rows += len(ref.lines)
            continue
        d = digest(path)
        if d not in seen:
            got = vcf_rows(path, ref.keys)
            seen[d] = sum(g != e for g, e in zip(got, ref.lines))
        bad_rows += seen[d]
    if counts is None:
        bad_counts = len(ref.lines)
    else:
        bad_counts = sum(tuple(counts.get(int(p), (-1, -1))) != tuple(c)
                         for p, c in zip(ref.sites.tolist(),
                                         ref.counts.tolist()))
    return {"vcf_sites": bad_rows, "count_sites": bad_counts}
