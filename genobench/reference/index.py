"""The reference's own index, rebuilt from the FASTA and the VCF with plain
numpy: the reference dictionary, the SNP dictionary, the two Bloom filters
and the pileup sites. A restatement of VarGeno's ``index`` (dictgen.c,
generate_bf.cc) for the inputs the benchmark writes (upper-case ACGT
sequences, single-base REF and ALT, CAF frequencies); it raises on
anything else. It shares no code with the program under test.

Positions are 1-based offsets into the concatenated chromosomes. A k-mer
packs base ``t`` of its 32 at bits ``2t``.

- Reference dictionary: every 32-mer, sorted (stable: equal keys keep
  genome order); a key seen once keeps its position, 2-10 times points to
  an aux row of its positions (rows numbered in key order), more than 10
  times is POS_AMBIGUOUS.
- SNP dictionary: for each SNP at least 32 bases from either end, the 32
  k-mers covering it with the ALT base, each with its start, the SNP's
  offset and REF code, and the CAF bytes; grouped as above.
- Reference Bloom filter: ``hash32(low 32 bits) % bits`` of every 32-mer.
- SNP Bloom filter: ``hash40(low 40 bits) % bits`` of the 32-mer LEFT of
  each SNP (the reference's shift_kmer result is discarded, so that is
  what it inserts).
- Sites: one per position seeded by an unambiguous SNP-dictionary row;
  where several rows seed one position, the last in key order wins.
"""

from __future__ import annotations

import dataclasses

import numpy as np

POS_AMBIGUOUS = 0xFFFFFFFF
FLAG_UNAMBIGUOUS, FLAG_AMBIGUOUS = 0, 1
AUX_COLS = 10
CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i
U64 = np.uint64


def hash32(x):
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        m = np.uint32(0x45D9F3B)
        x = ((x >> np.uint32(16)) ^ x) * m
        x = ((x >> np.uint32(16)) ^ x) * m
        return (x >> np.uint32(16)) ^ x


def hash40(x):
    x = np.asarray(x, U64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> U64(30))) * U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> U64(27))) * U64(0x94D049BB133111EB)
        return x ^ (x >> U64(31))


@dataclasses.dataclass
class Chrom:
    name: str
    codes: np.ndarray     # uint8 A0 C1 G2 T3
    start: int            # 1-based global position of its first base


@dataclasses.dataclass
class Snp:
    chrom: str
    pos1: int             # 1-based position in its chromosome
    ref: int
    alt: int
    rf: int               # CAF bytes, (uint8)(float32(f) * 255)
    af: int
    line: str             # the VCF row as written


def sorted_unique(a: np.ndarray) -> np.ndarray:
    """The distinct values of ``a``, ascending (by a sort: numpy's own
    ``unique`` hashes integers, which is far slower at these sizes)."""
    s = np.sort(a)
    keep = np.ones(s.shape[0], bool)
    keep[1:] = s[1:] != s[:-1]
    return s[keep]


class Bloom:
    """A filter of ``bits`` bits, held as the sorted set of its set bits."""

    def __init__(self, bits: int, set_bits: np.ndarray):
        self.bits = bits
        self.ones = sorted_unique(np.asarray(set_bits, U64))

    def test_bits(self, idx) -> np.ndarray:
        idx = np.asarray(idx, U64)
        i = np.minimum(np.searchsorted(self.ones, idx), self.ones.size - 1)
        return self.ones[i] == idx


@dataclasses.dataclass
class Index:
    ref_kmers: np.ndarray
    ref_pos: np.ndarray
    ref_flag: np.ndarray
    ref_aux: np.ndarray
    snp_kmers: np.ndarray
    snp_pos: np.ndarray
    snp_info: np.ndarray
    snp_flag: np.ndarray
    snp_aux_pos: np.ndarray
    snp_aux_snp: np.ndarray
    ref_bf: Bloom
    snp_bf: Bloom
    site_pos: np.ndarray   # ascending
    site_ref: np.ndarray
    site_alt: np.ndarray
    site_rf: np.ndarray
    site_af: np.ndarray
    chroms: list
    snps: dict             # 1-based global position -> Snp


def read_fasta(path: str) -> list:
    with open(path, "rb") as f:
        data = f.read()
    out, start = [], 1
    for part in data.split(b">")[1:]:
        head, _, body = part.partition(b"\n")
        codes = CODE[np.frombuffer(body.replace(b"\n", b""), np.uint8)]
        if (codes > 3).any():
            raise ValueError("the reference reads upper-case ACGT only")
        out.append(Chrom(head.decode().split()[0], codes, start))
        start += codes.shape[0]
    return out


def caf_byte(f: float) -> int:
    return int(np.uint8(np.float32(f) * np.float32(255.0)))


def read_vcf(path: str) -> list:
    out = []
    caf_bytes: dict = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            c = line.rstrip("\n").split("\t")
            if len(c[3]) != 1 or len(c[4]) != 1:
                raise ValueError("the reference reads single-base SNPs only")
            caf = next(t for t in c[7].split(";") if t.startswith("CAF="))
            rf_af = caf_bytes.get(caf)
            if rf_af is None:
                f1, f2 = caf[4:].split(",")
                rf_af = caf_bytes[caf] = (caf_byte(float(f1)),
                                          caf_byte(float(f2)))
            out.append(Snp(c[0], int(c[1]), int(CODE[ord(c[3])]),
                           int(CODE[ord(c[4])]), *rf_af, line.rstrip("\n")))
    return out


def kmers_of(codes: np.ndarray) -> np.ndarray:
    """Every 32-mer of ``codes``, one per start: for each start modulo 4,
    the bases packed four a byte (base t at bits 2t), and each k-mer read
    as the eight bytes from its start."""
    n = codes.shape[0] - 31
    out = np.zeros(max(n, 0), U64)
    for r in range(4):
        m = (n - r + 3) // 4           # starts r, r + 4, ...
        if m <= 0:
            continue
        q = np.zeros(4 * (m + 7), np.uint8)
        tail = codes[r:r + q.shape[0]]
        q[:tail.shape[0]] = tail
        q = q.reshape(-1, 4)
        b = q[:, 0] | q[:, 1] << 2 | q[:, 2] << 4 | q[:, 3] << 6
        out[r::4] = np.ndarray((m,), "<u8", b.tobytes(), 0, (1,))
    return out


def stable_order(keys: np.ndarray) -> np.ndarray:
    """The order of a stable sort of ``keys``: a plain sort, then the rows
    of each run of equal keys put back in their first order."""
    order = np.argsort(keys)
    ks = keys[order]
    dup = np.flatnonzero(ks[1:] == ks[:-1])
    if dup.size:
        rows = sorted_unique(np.concatenate([dup, dup + 1]))
        order[rows] = order[rows[np.lexsort((order[rows], ks[rows]))]]
    return order


def group(keys: np.ndarray, cols: list):
    """Sorted unique keys and, per key, (count, first row) over a stable
    sort; ``cols`` are permuted alike. Returns (keys, counts, first,
    sorted cols)."""
    order = stable_order(keys)
    keys = keys[order]
    cols = [c[order] for c in cols]
    starts = np.ones(keys.shape[0], bool)
    starts[1:] = keys[1:] != keys[:-1]
    first = np.flatnonzero(starts)
    counts = np.diff(np.append(first, keys.shape[0]))
    return keys[first], counts, first, cols


def aux_table(first, counts, sel, values, dtype):
    """Zero-padded AUX_COLS rows of ``values`` for the selected keys."""
    f, c = first[sel], counts[sel]
    col = np.arange(AUX_COLS)
    idx = np.minimum(f[:, None] + col, max(values.shape[0] - 1, 0))
    out = np.zeros((f.shape[0], AUX_COLS), dtype)
    valid = col < c[:, None]
    out[valid] = values[idx][valid]
    return out


def rows_meta(counts, first, pos_sorted):
    """(pos, flag, aux-row selection) of grouped dictionary keys."""
    single = counts == 1
    has_aux = (counts > 1) & (counts <= AUX_COLS)
    aux_id = np.cumsum(has_aux) - 1
    pos = np.where(single, pos_sorted[first],
                   np.where(has_aux, aux_id, POS_AMBIGUOUS)).astype(np.uint32)
    flag = np.where(single, FLAG_UNAMBIGUOUS, FLAG_AMBIGUOUS).astype(np.uint8)
    return pos, flag, has_aux


def build(fasta: str, vcf: str, ref_bf_bits: int, snp_bf_bits: int) -> Index:
    chroms = read_fasta(fasta)
    by_name = {c.name: c for c in chroms}
    rows = read_vcf(vcf)

    # reference dictionary and Bloom filter
    keys = [kmers_of(c.codes) for c in chroms]
    pos = [np.arange(k.shape[0], dtype=np.uint32) + np.uint32(c.start)
           for k, c in zip(keys, chroms)]
    keys, pos = np.concatenate(keys), np.concatenate(pos)
    ref_bf = Bloom(ref_bf_bits, hash32((keys & U64(0xFFFFFFFF))
                                       .astype(np.uint32)).astype(U64)
                   % U64(ref_bf_bits))
    uniq, counts, first, (pos_s,) = group(keys, [pos])
    del keys, pos
    r_pos, r_flag, r_aux = rows_meta(counts, first, pos_s)
    ref_aux = aux_table(first, counts, r_aux, pos_s, np.uint32)
    ref_kmers = uniq
    del uniq, counts, first, pos_s

    # SNP dictionary, SNP Bloom filter
    kept = [s for s in rows if 32 <= s.pos1 - 1 <= by_name[s.chrom]
            .codes.shape[0] - 32 and s.alt != s.ref]
    for s in kept:
        if by_name[s.chrom].codes[s.pos1 - 1] != s.ref:
            raise ValueError(f"REF of {s.chrom}:{s.pos1} is not the genome's")
    n = len(kept)
    idx = np.array([s.pos1 - 1 for s in kept], np.int64)
    start = np.array([by_name[s.chrom].start for s in kept], np.int64)
    ref = np.array([s.ref for s in kept], np.uint8)
    alt = np.array([s.alt for s in kept], U64)
    rf = np.array([s.rf for s in kept], np.uint8)
    af = np.array([s.af for s in kept], np.uint8)
    left = np.zeros(n, U64)
    kk = np.zeros((n, 32), U64)
    for name in {s.chrom for s in kept}:
        sel = np.flatnonzero(np.array([s.chrom == name for s in kept]))
        codes = by_name[name].codes.astype(U64)
        win = codes[idx[sel, None] + np.arange(-32, 32)]       # (r, 64)
        k = np.zeros(sel.size, U64)
        for t in range(32):
            k |= win[:, t] << U64(2 * t)
        left[sel] = k                 # the 32-mer left of the SNP
        for i in range(32):           # k-mer i starts at idx - 31 + i
            k = (k >> U64(2)) | (win[:, 32 + i] << U64(62))
            at = U64(2 * (31 - i))    # the SNP's base in it
            kk[sel, i] = (k & ~(U64(3) << at)) | (alt[sel] << at)
    snp_bf = Bloom(snp_bf_bits, hash40(left & U64(0xFF_FFFF_FFFF))
                   % U64(snp_bf_bits))
    i32 = np.arange(32, dtype=np.int64)
    s_keys = kk.reshape(-1)
    s_pos = (start[:, None] + idx[:, None] - 31 + i32).astype(np.uint32)
    s_info = (((31 - i32) << 3) | ref[:, None]).astype(np.uint8)
    s_rf, s_af = np.repeat(rf, 32), np.repeat(af, 32)
    uniq, counts, first, (p_s, i_s, rf_s, af_s) = group(
        s_keys, [s_pos.reshape(-1), s_info.reshape(-1), s_rf, s_af])
    snp_pos, snp_flag, s_aux = rows_meta(counts, first, p_s)
    single = counts == 1
    snp_info = np.where(single, i_s[first], 0).astype(np.uint8)
    row_rf = np.where(single, rf_s[first], 0).astype(np.uint8)
    row_af = np.where(single, af_s[first], 0).astype(np.uint8)

    # sites: unambiguous rows seed position pos + offset
    sel = np.flatnonzero(single)
    off = (snp_info[sel] >> 3) & 0x1F
    site = snp_pos[sel].astype(np.int64) + off
    s_alt = ((uniq[sel] >> (U64(2) * off.astype(U64))) & U64(3)).astype(
        np.uint8)
    order = np.argsort(site, kind="stable")   # later rows win
    ends = np.ones(order.shape[0], bool)
    ends[:-1] = site[order][1:] != site[order][:-1]
    take = order[ends]
    sites_ref = (snp_info[sel][take] & 7).astype(np.uint8)
    return Index(
        ref_kmers=ref_kmers, ref_pos=r_pos, ref_flag=r_flag, ref_aux=ref_aux,
        snp_kmers=uniq, snp_pos=snp_pos, snp_info=snp_info,
        snp_flag=snp_flag,
        snp_aux_pos=aux_table(first, counts, s_aux, p_s, np.uint32),
        snp_aux_snp=aux_table(first, counts, s_aux, i_s, np.uint8),
        ref_bf=ref_bf, snp_bf=snp_bf,
        site_pos=site[take].astype(np.int64), site_ref=sites_ref,
        site_alt=s_alt[take], site_rf=row_rf[sel][take],
        site_af=row_af[sel][take], chroms=chroms,
        snps={by_name[s.chrom].start + s.pos1 - 1: s for s in kept})
