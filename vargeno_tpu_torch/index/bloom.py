"""Jax-free port of ``vargeno_tpu/index/bloom.py``, no longer a pure copy:
``build_snp_bf`` reads each SNP's 32 left bases instead of whole-chromosome
prefix sums and rolling k-mers; its filter must equal the JAX
``build_snp_bf``'s bit for bit (tests/test_torch_wgs_stream.py).

Bloom filter construction as bit-packed numpy/uint arrays.

Replicates the reference's single-hash Bloom filters (src/generate_bf.h:38-190,
src/generate_bf.cc:90-277) including their quirks:

- The ref filter keys on LO32 of every reference 32-mer through ``hash32``;
  its 9.6e9 bits exceed 2**32 so the modulo is the identity
  (src/generate_bf.cc:146-147, src/generate_bf.h:125-130, 201).
- A "lite" filter keyed on LO40 is also written but never loaded by `geno`
  (src/generate_bf.cc:102-105, 148-149).
- The SNP filter insertion loop DISCARDS the result of shift_kmer
  (src/generate_bf.cc:257), so what is actually inserted is hash40 of the
  LO40 of the 32-mer immediately LEFT of each SNP — once per SNP row that
  survives the filters and has a non-N ALT. This shipped bug is replicated
  because the expected outputs depend on it (SURVEY.md §6.1 item 1).
- The BF path parses FASTA with raw (un-normalized) sequences and full-header
  names, and compares REF bases case-sensitively (src/generate_bf.cc:230).

Bitmaps are stored LSB-first in uint64 words (bit i -> word i>>6, bit i&63),
matching sdsl::bit_vector's memory layout so the reference's .bf files can be
imported/exported losslessly; the same buffer reinterpreted as little-endian
uint32 words is what the TPU engine consumes.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..core.hashes import np_hash32, np_hash40
from ..core.kmer import np_rolling_kmers_u64, np_window_has_n
from ..io.fasta import Seq
from ..io.vcf import iter_vcf_rows

_LO40_MASK = np.uint64(0xFF_FFFF_FFFF)


@dataclasses.dataclass
class BitVector:
    bits: int
    words: np.ndarray  # (ceil(bits/64),) uint64, LSB-first

    @classmethod
    def zeros(cls, bits: int) -> "BitVector":
        return cls(bits=bits, words=np.zeros((bits + 63) // 64, np.uint64))

    def set_bits(self, idx: np.ndarray) -> None:
        idx = np.asarray(idx, dtype=np.uint64)
        from .. import native

        if idx.size > 4096 and native.available():
            native.bf_set_bits(self.words, idx)
            return
        w = (idx >> np.uint64(6)).astype(np.int64)
        m = np.uint64(1) << (idx & np.uint64(63))
        np.bitwise_or.at(self.words, w, m)

    def set_hashes_mod(self, hashes: np.ndarray) -> None:
        """set_bits(hashes % bits), with the u64 modulo fused into the
        native pass (numpy's u64 % is a scalar fallback)."""
        hashes = np.asarray(hashes, dtype=np.uint64)
        from .. import native

        if hashes.size > 4096 and native.available():
            native.bf_mod_set(self.words, hashes, self.bits)
            return
        self.set_bits(hashes % np.uint64(self.bits))

    def test_bits(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, dtype=np.uint64)
        w = (idx >> np.uint64(6)).astype(np.int64)
        b = (idx & np.uint64(63)).astype(np.uint64)
        return ((self.words[w] >> b) & np.uint64(1)).astype(bool)

    def count_ones(self) -> int:
        # numpy>=2 has bitwise_count
        return int(np.bitwise_count(self.words).sum())

    def as_u32(self) -> np.ndarray:
        """Little-endian uint32 view preserving LSB-first bit order
        (bit i -> u32 word i>>5, bit i&31)."""
        return self.words.view("<u8").view("<u4")


def ref_bf_bits_from_kmers(kmers: np.ndarray, bits: int) -> np.ndarray:
    """Bit indices for ref-kmer insertion: hash32(LO32) % bits. At the
    reference geometry (9.6e9 bits > 2**32) the modulo is the identity."""
    lo = (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np_hash32(lo).astype(np.uint64) % np.uint64(bits)


def lite_bf_bits_from_kmers(kmers: np.ndarray, bits: int) -> np.ndarray:
    lo40 = kmers & _LO40_MASK
    return np_hash40(lo40) % np.uint64(bits)


def snp_bf_bit_from_left_kmer(kmers: np.ndarray, bits: int) -> np.ndarray:
    lo40 = kmers & _LO40_MASK
    return np_hash40(lo40) % np.uint64(bits)


def build_ref_bfs(seqs: List[Seq], ref_bits: int, lite_bits: int):
    """constructBfFromGenomeseq (src/generate_bf.cc:90-168): every N-free
    32-mer of every raw sequence goes into the ref (LO32/hash32) and lite
    (LO40/hash40) filters. Non-ACGTN characters abort (encode_kmer's
    assert, src/util.c:104)."""
    ref_bf = BitVector.zeros(ref_bits)
    lite_bf = BitVector.zeros(lite_bits)
    CH = 1 << 27   # chunked: full-width rolling-kmer temporaries at
    # whole-genome scale (24 GB+) contributed to OOM on the 3 Gb rehearsal
    for s in seqs:
        codes = s.codes_raw()
        if (codes > 4).any():
            bad = np.flatnonzero(codes > 4)[0]
            raise ValueError(
                f"invalid character {s.raw[bad:bad+1]!r} in sequence "
                f"{s.full_name!r} (reference would abort)")
        if s.size < 32:
            raise ValueError("sequence shorter than k (reference asserts)")
        n = codes.shape[0]
        for s0 in range(0, max(n - 31, 1), CH):
            kmers = _valid_rolling_kmers(codes[s0:min(s0 + CH + 31, n)])
            lo = (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            ref_bf.set_hashes_mod(np_hash32(lo).astype(np.uint64))
            lite_bf.set_hashes_mod(np_hash40(kmers & _LO40_MASK))
    return ref_bf, lite_bf


def _valid_rolling_kmers(codes: np.ndarray) -> np.ndarray:
    from .. import native

    if codes.size > 4096 and native.available():
        roll, ok = native.rolling_kmers(codes)
    else:
        roll = np_rolling_kmers_u64(codes)
        ok = ~np_window_has_n(codes)
    return roll[ok]


def build_snp_bf(seqs: List[Seq], vcf_path: str, snp_bits: int) -> BitVector:
    """constructBfFromVcf (src/generate_bf.cc:179-277), with the shift_kmer
    discard quirk: per surviving row, a single insertion of the k-mer left
    of the SNP. Matching is by FULL fasta header names against
    'chr'-prefixed VCF chromosome names, with stale-sequence semantics when
    a chromosome is not found (the previous sequence stays active,
    src/generate_bf.cc:214-222)."""
    bf = BitVector.zeros(snp_bits)
    pre_chr_name = "XO"
    cur: Seq | None = None

    # scalar filters + chromosome state machine stay in the scan; the left-
    # window N checks and k-mer packing (per-row 32-step loops before) are
    # batched per chromosome afterwards. Bloom insertion is an idempotent
    # OR, so batch order does not matter; the two abort conditions are
    # re-raised for the FIRST offending row in scan order to match the
    # sequential semantics (a >4 char raises before the ALT check iff the
    # left window is N-free -- cc:230-260 evaluation order).
    c_seq = []
    c_pos = []
    c_alt = []

    for row in iter_vcf_rows(vcf_path):
        chr_name = row.chrom
        if not chr_name.startswith("c"):
            chr_name = "chr" + chr_name
        if len(row.ref) > 1 or len(row.alt) > 1:
            continue
        if chr_name != pre_chr_name:
            for s in seqs:
                if s.full_name == chr_name:
                    cur = s
                    break
            pre_chr_name = chr_name
        seq_len = cur.size if cur is not None else 0
        pos = row.pos1 - 1
        if pos < 32 or (pos + 32) > seq_len:
            continue
        ref_nt = row.ref  # raw, case-sensitive compare (cc:230)
        alt_nt = row.alt
        if cur is None or chr(cur.raw[pos]) != ref_nt or ref_nt == alt_nt:
            continue
        c_seq.append(cur)
        c_pos.append(pos)
        c_alt.append(alt_nt)

    n = len(c_pos)
    if n == 0:
        return bf
    pos_a = np.asarray(c_pos, np.int64)
    alt_a = np.asarray(c_alt)
    bad_char = np.zeros(n, bool)   # any code > 4 in the left window
    has_n = np.zeros(n, bool)      # any code > 3 in the left window
    kmer_a = np.zeros(n, np.uint64)
    groups = {}
    for i, s in enumerate(c_seq):
        groups.setdefault(id(s), (s, []))[1].append(i)
    left = np.arange(-32, 0, dtype=np.int64)
    for s, rows_l in groups.values():
        codes = s.codes_raw()
        for r0 in range(0, len(rows_l), 1 << 20):
            rows = np.asarray(rows_l[r0:r0 + (1 << 20)], np.int64)
            win = codes[pos_a[rows, None] + left[None, :]]   # (r, 32)
            bad_char[rows] = (win > 4).any(1)
            n_free = ~(win > 3).any(1)
            has_n[rows] = ~n_free
            # the left k-mer, base t at bits 2t (the rolling k-mers')
            w = win[n_free].astype(np.uint64)
            k = np.zeros(w.shape[0], np.uint64)
            for t in range(32):
                k |= w[:, t] << np.uint64(2 * t)
            kmer_a[rows[n_free]] = k

    alt_n = (alt_a == "N") | (alt_a == "n")
    # '' passes the C substring test (strstr semantics of `x in "ACGTacgt"`)
    alt_bad = ~np.isin(alt_a, list("ACGTacgt") + [""])
    raise_char = bad_char
    raise_alt = ~bad_char & ~has_n & alt_bad
    any_raise = raise_char | raise_alt
    if any_raise.any():
        first = int(np.flatnonzero(any_raise)[0])
        if raise_char[first]:
            raise ValueError("invalid character in k-mer (reference aborts)")
        raise ValueError(
            f"ALT {alt_a[first]!r} would abort shift_kmer in the reference")
    ins = ~has_n & ~alt_n
    if ins.any():
        bf.set_hashes_mod(np_hash40(kmer_a[ins] & _LO40_MASK))
    return bf
