"""The benchmark's inputs, made from a seed: a genome (FASTA), its known
SNPs (VCF) and one sample's reads (FASTQ), written with vectorised numpy.

A configuration file gives the genome and its SNPs (``genome_bases``,
``snps``, ``chrom``, optional ``families``); a mix file gives the reads
(``coverage``, ``read_len``, ``rc_frac``) and the sequencer's quality and
error profile (``high_q``, ``high_share``, ``error_rate``). The same seed
gives the same bytes, and every seed gives the same sizes.

The draws: uniform bases, optionally with segment families planted over a
share of them (2-10 copies of 1-3 kb, 1 % divergence, one exact high-copy
family), bi-allelic SNPs with CAF 0.99 / 0.9 / 0.7 and a diploid genotype
each (0, 1, 2 alt copies at 0.5 / 0.3 / 0.2), and reads sliced from
either haplotype at uniform starts, a share of them reverse-complemented.
Each base of a read, as sequenced, gets its quality on its own: the high
level with probability ``high_share``, else the low level; it is then
miscalled with the probability its quality states (Phred), the low
level's set so that the mean over bases is ``error_rate``
(``quality_levels``). Errors and qualities are drawn per base, so where
they fall is independent of the k-mers the program flags.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

ASCII = np.frombuffer(b"ACGT", np.uint8)
COMP = np.array([3, 2, 1, 0], np.uint8)
CAFS = np.array([0.99, 0.9, 0.7])
GT_P = (0.5, 0.3, 0.2)
PHRED = 33              # quality characters are Phred + 33
CHUNK = 1 << 18          # reads drawn and written at a time
LINE = 70                # FASTA line width
ID_DIGITS = 9            # read names are "@r" and 9 digits: fixed records


@dataclasses.dataclass
class Inputs:
    fasta: str
    vcf: str
    fastq: str
    n_reads: int


def n_reads(cfg: dict, mix: dict) -> int:
    """Reads a sample: the mix's coverage of the configuration's genome."""
    return round(float(mix["coverage"]) * int(cfg["genome_bases"])
                 / int(mix["read_len"]))


def quality_levels(mix: dict) -> tuple:
    """(high character, low character, P(miscall) at high, at low): the
    high level is Phred ``high_q``; the low level's miscall probability
    makes the mean over bases ``error_rate``, and its character is that
    probability's Phred score, rounded."""
    s = float(mix["high_share"])
    p_high = 10 ** (-float(mix["high_q"]) / 10)
    p_low = (float(mix["error_rate"]) - s * p_high) / (1 - s)
    if not 0 < p_low < 0.75:
        raise ValueError(f"no low quality level gives error_rate "
                         f"{mix['error_rate']} at {mix}")
    q_low = round(-10 * np.log10(p_low))
    return PHRED + int(mix["high_q"]), PHRED + q_low, p_high, p_low


def plant_families(rng, g, dup_share, copies=(2, 10), seg_len=(1000, 3000),
                   divergence=0.01, high_copy=(16, 400)):
    """Write segment families into the base codes ``g`` in place until they
    cover about ``dup_share`` of it: a random segment of ``seg_len`` bases
    at ``copies`` random places, each copy with its own substitutions at
    rate ``divergence``; ``high_copy`` = (copies, length) adds one exact
    family of more copies than the dictionary's aux rows hold."""
    size = g.shape[0]
    covered = 0
    while covered < dup_share * size:
        n = int(rng.integers(copies[0], copies[1] + 1))
        length = int(rng.integers(seg_len[0], seg_len[1] + 1))
        seg = rng.integers(0, 4, length, dtype=np.uint8)
        for p in rng.integers(0, size - length, n):
            cp = seg.copy()
            sub = np.flatnonzero(rng.random(length) < divergence)
            cp[sub] = (cp[sub] + rng.integers(1, 4, sub.size)) % 4
            g[p:p + length] = cp
        covered += n * length
    if high_copy is not None:
        n, length = high_copy
        seg = rng.integers(0, 4, length, dtype=np.uint8)
        for p in rng.integers(0, size - length, n):
            g[p:p + length] = seg


def genome(rng, cfg: dict) -> np.ndarray:
    """The genome's base codes (A0 C1 G2 T3)."""
    g = rng.integers(0, 4, int(cfg["genome_bases"]), dtype=np.uint8)
    fam = cfg.get("families")
    if fam:
        plant_families(rng, g, fam["dup_share"], tuple(fam["copies"]),
                       tuple(fam["seg_len"]), fam["divergence"],
                       tuple(fam["high_copy"]) if fam.get("high_copy")
                       else None)
    return g


def snps(rng, g: np.ndarray, n: int):
    """(0-based positions ascending, ref codes, alt codes, CAF of the ref
    allele, alt copies 0-2) of ``n`` SNPs at distinct positions at least
    64 bases from either end."""
    pos = np.sort(rng.choice(g.shape[0] - 128, n, replace=False) + 64)
    ref = g[pos]
    alt = ((ref + rng.integers(1, 4, n)) % 4).astype(np.uint8)
    caf = CAFS[rng.integers(0, 3, n)]
    gt = rng.choice(3, n, p=GT_P)
    return pos, ref, alt, caf, gt


def write_fasta(path: str, name: str, g: np.ndarray) -> None:
    full = g.shape[0] // LINE * LINE
    rows = np.empty((full // LINE, LINE + 1), np.uint8)
    rows[:, :LINE] = ASCII[g[:full]].reshape(-1, LINE)
    rows[:, LINE] = ord("\n")
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        f.write(rows.tobytes())
        if full < g.shape[0]:
            f.write(ASCII[g[full:]].tobytes() + b"\n")


def write_vcf(path: str, name: str, pos, ref, alt, caf) -> None:
    r, a = ASCII[ref], ASCII[alt]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.0\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        f.write("".join(
            f"{name}\t{p + 1}\trs{j}\t{chr(x)}\t{chr(y)}\t.\t.\t"
            f"RS={j};CAF={c:.4g},{1 - c:.4g}\n"
            for j, (p, x, y, c) in enumerate(zip(
                pos.tolist(), r.tolist(), a.tolist(), caf.tolist()))))


def haplotypes(g, pos, alt, gt):
    """(hap0, hap1): alt bases on both at gt 2, on hap1 alone at gt 1."""
    h0, h1 = g.copy(), g.copy()
    h0[pos[gt == 2]] = alt[gt == 2]
    h1[pos[gt >= 1]] = alt[gt >= 1]
    return h0, h1


def read_records(rng, haps, first: int, n: int, mix: dict) -> bytes:
    """``n`` FASTQ records, named from ``first`` on, as one block of bytes
    (each record the same length)."""
    L = int(mix["read_len"])
    size = haps[0].shape[0]
    start = rng.integers(0, size - L, n)
    hap = rng.integers(0, 2, n)
    win = [np.lib.stride_tricks.sliding_window_view(h, L) for h in haps]
    reads = np.where(hap[:, None] == 0, win[0][start], win[1][start])
    rc = rng.random(n) < mix["rc_frac"]
    reads[rc] = COMP[reads[rc, ::-1]]
    # one uniform draw a base: below ``a`` the base is of low quality,
    # and miscalled in the first p_low of that range; above, miscalled in
    # the first p_high of the rest
    hi, lo, p_high, p_low = quality_levels(mix)
    a = 1 - float(mix["high_share"])
    u = rng.random((n, L), dtype=np.float32)
    low = u < np.float32(a)
    err = (u < np.float32(a * p_low)) | (
        ~low & (u < np.float32(a + (1 - a) * p_high)))
    e = np.nonzero(err)
    reads[e] = (reads[e] + rng.integers(1, 4, e[0].size, dtype=np.uint8)) % 4
    qual = np.uint8(hi) - np.uint8(hi - lo) * low.view(np.uint8)

    width = 2 + ID_DIGITS + 1 + L + 1 + 2 + L + 1
    rec = np.empty((n, width), np.uint8)
    rec[:, 0:2] = np.frombuffer(b"@r", np.uint8)
    ids = first + np.arange(n, dtype=np.int64)
    for d in range(ID_DIGITS):
        rec[:, 2 + d] = 48 + ids // 10 ** (ID_DIGITS - 1 - d) % 10
    o = 2 + ID_DIGITS
    rec[:, o] = ord("\n")
    rec[:, o + 1:o + 1 + L] = ASCII[reads]
    o += 1 + L
    rec[:, o:o + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, o + 3:o + 3 + L] = qual
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def make_inputs(seed: int, cfg: dict, mix: dict, out_dir: str) -> Inputs:
    """Write the cell's FASTA, VCF and FASTQ into ``out_dir``."""
    rng = np.random.default_rng(seed)
    name = cfg["chrom"]
    g = genome(rng, cfg)
    pos, ref, alt, caf, gt = snps(rng, g, int(cfg["snps"]))
    paths = Inputs(os.path.join(out_dir, "genome.fa"),
                   os.path.join(out_dir, "snps.vcf"),
                   os.path.join(out_dir, "reads.fq"), n_reads(cfg, mix))
    write_fasta(paths.fasta, name, g)
    write_vcf(paths.vcf, name, pos, ref, alt, caf)
    haps = haplotypes(g, pos, alt, gt)
    del g
    with open(paths.fastq, "wb") as f:
        for first in range(0, paths.n_reads, CHUNK):
            f.write(read_records(rng, haps, first,
                                 min(CHUNK, paths.n_reads - first), mix))
    return paths
