"""Jax-free copy of ``vargeno_tpu/index/ucsc.py``.

UCSC SNP-txt format support: dictionary build + Bloom filters.

Mirrors the reference's UCSC paths:
- ``build_snp_dict_ucsc``: make_snp_dict (src/dictgen.c:350-540).
  Fields (tab-split): CHROM=1, INDEX=2 (0-based), STRAND=6, REF1=7, REF2=8,
  ALT(observed)=9, TYPE=11, COUNT=21, ALLELES=22, FREQS=24. Rows kept iff
  REF1 encodes ACGT, TYPE starts with "single", REF1==REF2, both single
  char, chrom known (dict-style names, no 'chr' prefixing), genome base
  matches (else hard error), 32-kmer window in range, COUNT=='2', strand
  +/-, alleles ACGT (hard assert) with reverse-complement on '-', at least
  one allele equals REF. Frequencies come from the FREQS field and are
  swapped when allele 2 is the reference (dictgen.c:476-480). Only the
  FIRST valid observed-alt character generates k-mers (the loop body ends
  in `end: break`, dictgen.c:520-521).
- ``build_snp_bf_ucsc``: constructBfFromUcsc (src/generate_bf.cc:439-592):
  BF-style (full-header) names, inserts LO40 of the LEFT k-mer (even when
  it contained N and encoded as 0!) plus all 32 covering k-mers -- note
  this variant assigns shift_kmer's result (no discard bug, unlike the VCF
  variant at cc:257).
- ``build_snp_bf_encode``: constructBfFromEncode (cc:615-652): one integer
  per line (strtoull base-0: 0x-hex etc.), inserted via hash40.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import BASE_X
from ..core.kmer import np_codes_from_bytes
from ..io.fasta import Seq
from ..io.vcf import _atof_prefix, encode_freq
from .bloom import BitVector, snp_bf_bit_from_left_kmer
from .dictgen import (SnpDict, _find_seq_by_name, _group_ambiguity,
                      _aux_rows, VcfRefMismatch)

_BASE_CODE = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
_REVC = {"A": "T", "a": "T", "C": "G", "c": "G", "G": "C", "g": "C",
         "T": "A", "t": "A"}

CHROM, INDEX, STRAND, REF1, REF2, ALT, TYPE, COUNT, ALLELES, FREQS = (
    1, 2, 6, 7, 8, 9, 11, 21, 22, 24)


def _rev(c: str) -> str:
    return _REVC.get(c, "N")


def build_snp_dict_ucsc(seqs: List[Seq], ucsc_path: str, aux_cols: int = 10
                        ) -> Tuple[SnpDict, np.ndarray]:
    kmer_rows, pos_rows, snp_rows, rf_rows, af_rows = [], [], [], [], []
    snp_locs: List[int] = []
    chrom: Seq | None = None
    chrom_start = 1
    norm_cache = {}
    shifts = np.arange(32, dtype=np.uint64) * np.uint64(2)

    def norm_codes(s: Seq) -> np.ndarray:
        r = norm_cache.get(id(s))
        if r is None:
            r = s.codes_normalized()
            norm_cache[id(s)] = r
        return r

    with open(ucsc_path) as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) <= FREQS:
                cols = cols + [""] * (FREQS + 1 - len(cols))
            ref_ch = cols[REF1][:1].upper()
            ref_u = _BASE_CODE.get(ref_ch, BASE_X)
            if (ref_u == BASE_X
                    or not cols[TYPE].startswith("single")
                    or ref_ch != cols[REF2][:1].upper()):
                continue
            if len(cols[REF1]) != 1 or len(cols[REF2]) != 1:
                continue
            name = cols[CHROM]
            if chrom is None or chrom.name != name:
                chrom, chrom_start = _find_seq_by_name(seqs, name)
                if chrom is None:
                    continue
            index = int(cols[INDEX] or 0)
            codes = norm_codes(chrom)
            if index >= chrom.size or int(codes[index]) != ref_u:
                raise VcfRefMismatch(
                    f"Mismatch at 0-based index {index} in {chrom.name}")
            if index < 32 or (index + 32) > chrom.size:
                continue
            if not cols[COUNT].startswith("2"):
                continue
            neg = cols[STRAND][:1] == "-"
            if not neg and cols[STRAND][:1] != "+":
                raise AssertionError("strand must be + or - (reference "
                                     "asserts)")
            al = cols[ALLELES]
            a1 = _rev(al[0:1].upper()) if neg else al[0:1].upper()
            a2 = _rev(al[2:3].upper()) if neg else al[2:3].upper()
            if a1 not in "ACGT" or a2 not in "ACGT":
                raise AssertionError("non-ACGT allele (reference asserts)")
            if a1 != ref_ch and a2 != ref_ch:
                continue
            snp_locs.append(chrom_start + index)
            fr = cols[FREQS]
            comma = fr.find(",")
            freq1 = _atof_prefix(fr)
            freq2 = _atof_prefix(fr[comma + 1:]) if comma >= 0 else 0.0
            if a2 == ref_ch:
                freq1, freq2 = freq2, freq1
            rf_enc = encode_freq(freq1)
            af_enc = encode_freq(freq2)

            # observed-alt characters: first valid one wins
            for ch in cols[ALT]:
                if ch.isspace():
                    break
                alt = _rev(ch.upper()) if neg else ch.upper()
                if alt == ref_ch or alt not in "ACGT":
                    continue
                window = codes[index - 32: index + 32].copy()
                if (window[:32] > 3).any():
                    break  # left flank N: row aborted (goto end -> break)
                window[32] = _BASE_CODE[alt]
                if (window[32:] > 3).any():
                    break
                w = window.astype(np.uint64)
                kk = np.zeros(32, dtype=np.uint64)
                for j in range(32):
                    kk |= (w[1 + j: 33 + j] & np.uint64(3)) << shifts[j]
                i_arr = np.arange(32, dtype=np.uint32)
                kmer_rows.append(kk)
                pos_rows.append(np.uint32(chrom_start + index - 31) + i_arr)
                snp_rows.append(((np.uint32(31) - i_arr) << np.uint32(3)
                                 | np.uint32(ref_u)).astype(np.uint8))
                rf_rows.append(np.full(32, rf_enc, np.uint8))
                af_rows.append(np.full(32, af_enc, np.uint8))
                break

    if kmer_rows:
        kmers = np.concatenate(kmer_rows)
        pos = np.concatenate(pos_rows)
        snp = np.concatenate(snp_rows)
        rf = np.concatenate(rf_rows)
        af = np.concatenate(af_rows)
    else:
        kmers = np.zeros(0, np.uint64)
        pos = np.zeros(0, np.uint32)
        snp = rf = af = np.zeros(0, np.uint8)

    order = np.argsort(kmers, kind="stable")
    kmers, pos, snp, rf, af = (a[order] for a in (kmers, pos, snp, rf, af))
    uniq, first, counts, pos_or_aux, flag, has_aux = _group_ambiguity(
        kmers, aux_cols)
    single = counts == 1
    safe_first = np.minimum(first, max(len(pos) - 1, 0))
    out_pos = np.where(single, pos[safe_first] if len(pos) else 0,
                       pos_or_aux).astype(np.uint32)
    out_snp = np.where(single, snp[safe_first] if len(snp) else 0,
                       0).astype(np.uint8)
    out_rf = np.where(single, rf[safe_first] if len(rf) else 0,
                      0).astype(np.uint8)
    out_af = np.where(single, af[safe_first] if len(af) else 0,
                      0).astype(np.uint8)
    aux_pos = _aux_rows(first, counts, has_aux, pos, aux_cols, np.uint32)
    aux_snp = _aux_rows(first, counts, has_aux, snp, aux_cols, np.uint8)
    aux_rf = _aux_rows(first, counts, has_aux, rf, aux_cols, np.uint8)
    aux_af = _aux_rows(first, counts, has_aux, af, aux_cols, np.uint8)
    locs = np.zeros(max(snp_locs) + 1 if snp_locs else 10, dtype=bool)
    for l in snp_locs:
        locs[l] = True
    return (SnpDict(kmers=uniq, pos=out_pos, snp=out_snp, flag=flag,
                    ref_freq=out_rf, alt_freq=out_af,
                    aux_kmer=uniq[has_aux], aux_pos=aux_pos,
                    aux_snp=aux_snp, aux_rf=aux_rf, aux_af=aux_af), locs)


def build_snp_bf_ucsc(seqs: List[Seq], ucsc_path: str, snp_bits: int
                      ) -> BitVector:
    from ..core.hashes import np_hash40

    bf = BitVector.zeros(snp_bits)
    pre = "XO"
    cur: Seq | None = None
    raw_cache = {}

    def raw_codes(s):
        r = raw_cache.get(id(s))
        if r is None:
            r = s.codes_raw()
            raw_cache[id(s)] = r
        return r

    def insert_lo40(kmers_u64):
        bf.set_bits(np_hash40(np.asarray(kmers_u64, np.uint64)
                              & np.uint64(0xFF_FFFF_FFFF))
                    % np.uint64(snp_bits))

    with open(ucsc_path) as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) <= ALLELES:
                cols = cols + [""] * (ALLELES + 1 - len(cols))
            ref_ch = cols[REF1][:1].upper()
            ref_u = _BASE_CODE.get(ref_ch, BASE_X)
            if (ref_u == BASE_X or cols[TYPE] != "single"
                    or ref_ch != cols[REF2][:1].upper()):
                continue
            if len(cols[REF1]) != 1 or len(cols[REF2]) != 1:
                continue
            name = cols[CHROM]
            if name != pre:
                found = None
                for s in seqs:
                    if s.full_name == name:
                        found = s
                        break
                if found is None:
                    continue  # pre NOT updated (cc:502-503)
                cur = found
                pre = name
            index = int(cols[INDEX] or 0)
            raw = raw_cache.get(id(cur))
            if raw is None:
                raw = raw_codes(cur)
            if index >= cur.size or chr(cur.raw[index]).upper() != ref_ch:
                raise VcfRefMismatch("UCSC/FASTA mismatch (reference exits)")
            if index < 32 or (index + 32) > cur.size:
                continue
            if cols[COUNT] != "2":
                continue
            neg = cols[STRAND][:1] == "-"
            if not neg and cols[STRAND][:1] != "+":
                raise AssertionError("bad strand")
            al = cols[ALLELES]
            a1 = _rev(al[0:1].upper()) if neg else al[0:1].upper()
            a2 = _rev(al[2:3].upper()) if neg else al[2:3].upper()
            if a1 not in "ACGT" or a2 not in "ACGT":
                raise AssertionError("non-ACGT allele")
            if a1 != ref_ch and a2 != ref_ch:
                continue
            for ch in cols[ALT]:
                if ch.isspace():
                    break
                alt = _rev(ch.upper()) if neg else ch.upper()
                if alt == ref_ch or alt not in "ACGT":
                    continue
                window = raw[index - 32: index + 32]
                left = window[:32]
                had_n = (left > 3).any()
                if (left > 4).any():
                    raise ValueError("invalid char (encode_kmer aborts)")
                # left kmer inserted FIRST -- encode_kmer returns 0 on N,
                # and the insert happens before the had_n check (cc:551-555)
                k0 = np.uint64(0)
                if not had_n:
                    c = left.astype(np.uint64)
                    for j in range(32):
                        k0 |= (c[j] & np.uint64(3)) << np.uint64(2 * j)
                insert_lo40([k0])
                if had_n:
                    break
                covering = []
                km = int(k0)
                for i in range(32):
                    nb = int(window[32 + i]) if i else _BASE_CODE[alt]
                    if i and nb == 4:
                        break  # N aborts remaining inserts (goto end)
                    if i and nb > 4:
                        raise ValueError("invalid char (shift_kmer aborts)")
                    km = (km >> 2) | ((nb & 3) << 62)
                    covering.append(km)
                insert_lo40(covering)
                break
    return bf


def build_snp_bf_encode(encode_path: str, snp_bits: int) -> BitVector:
    from ..core.hashes import np_hash40

    bf = BitVector.zeros(snp_bits)
    vals = []
    with open(encode_path) as f:
        for line in f:
            if not line.strip():
                continue
            tok = line.split(" ")[0].strip()
            try:
                v = int(tok, 0)  # strtoull base-0 semantics
            except ValueError:
                v = 0
            vals.append(v & 0xFFFFFFFFFFFFFFFF)
    if vals:
        bf.set_bits(np_hash40(np.asarray(vals, np.uint64))
                    % np.uint64(snp_bits))
    return bf
