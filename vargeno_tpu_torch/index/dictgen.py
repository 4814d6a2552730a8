"""Jax-free port of ``vargeno_tpu/index/dictgen.py``, no longer a pure copy:
its arrays must equal those of the JAX ``build_ref_dict`` and
``build_snp_dict_from_vcf`` bit for bit (tests/test_torch_wgs_stream.py).

Index ("dictgen") build: sorted 32-mer dictionaries as flat numpy arrays.

Re-designs the reference's sequential writer (src/dictgen.c) as vectorized
numpy group-by operations: rolling k-mer extraction is 32 shifted ORs,
sorting is a stable argsort (matching glibc qsort's mergesort stability on
the reference's (kmer)-keyed records), and the ambiguity/aux-table encoding
(src/dictgen.c:83-135, 176-253) becomes unique+counts bookkeeping.

Output semantics are bit-identical to the reference's .dict files:
- unique k-mer rows sorted ascending;
- a k-mer with 2..10 positions gets pos=aux_row_index and FLAG_AMBIGUOUS,
  its positions stored in generation order, zero-padded to 10 columns;
- a k-mer with >10 positions gets pos=POS_AMBIGUOUS and consumes no aux row
  (src/dictgen.c:116-128).

Where the JAX module holds whole-genome temporaries, this one does not:
the ref dictionary is built in buckets of the key's top bits (one below
~89M rows), each sorted and grouped on its own and compacted in place
(``build_ref_dict``), and the SNP dictionary reads each SNP's 63 covering
bases instead of a rolling k-mer array of the whole chromosome.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..config import (
    AUX_TABLE_COLS_DEF,
    BASE_X,
    FLAG_AMBIGUOUS,
    FLAG_UNAMBIGUOUS,
    POS_AMBIGUOUS,
)
from ..core.kmer import np_rolling_kmers_u64, np_window_has_n
from ..io.fasta import Seq
from ..io.vcf import CafExtractor, encode_freq, iter_vcf_rows


def _stable_argsort_u64(kmers: np.ndarray) -> np.ndarray:
    """Stable key sort: threaded native LSD radix when available (the
    reference's qsort, dictgen.c:53-61, is the index build's dominant cost
    at genome scale), numpy otherwise."""
    if kmers.shape[0] >= (1 << 16) and kmers.shape[0] < (1 << 32):
        from .. import native

        if native.available():
            return native.radix_argsort(kmers)
    return np.argsort(kmers, kind="stable")


@dataclasses.dataclass
class RefDict:
    """The reference k-mer dictionary (mirrors prefix.ref.dict)."""

    kmers: np.ndarray   # (n,) uint64, sorted ascending, unique
    pos: np.ndarray     # (n,) uint32: position | aux row | POS_AMBIGUOUS
    flag: np.ndarray    # (n,) uint8
    aux: np.ndarray     # (m, 10) uint32, zero-padded position lists


@dataclasses.dataclass
class SnpDict:
    """The SNP k-mer dictionary (mirrors prefix.snp.dict)."""

    kmers: np.ndarray      # (n,) uint64, sorted ascending, unique
    pos: np.ndarray        # (n,) uint32
    snp: np.ndarray        # (n,) uint8 snp_info (0 for ambiguous rows)
    flag: np.ndarray       # (n,) uint8
    ref_freq: np.ndarray   # (n,) uint8 (0 for ambiguous rows)
    alt_freq: np.ndarray   # (n,) uint8
    aux_kmer: np.ndarray   # (m,) uint64
    aux_pos: np.ndarray    # (m, 10) uint32
    aux_snp: np.ndarray    # (m, 10) uint8
    aux_rf: np.ndarray     # (m, 10) uint8
    aux_af: np.ndarray     # (m, 10) uint8


def _group_ambiguity(kmers_sorted: np.ndarray, aux_cols: int):
    """unique kmers + first index + counts + aux row ids.

    Returns (uniq, first, counts, pos_or_aux, flag, aux_sel) where aux_sel
    is the boolean mask of unique kmers that own an aux row (2..10 copies),
    with aux rows numbered in ascending-kmer order as the sequential writer
    does (src/dictgen.c:125).
    """
    uniq, first, counts = np.unique(
        kmers_sorted, return_index=True, return_counts=True)
    flag = np.where(counts == 1, FLAG_UNAMBIGUOUS, FLAG_AMBIGUOUS).astype(
        np.uint8)
    has_aux = (counts > 1) & (counts <= aux_cols)
    aux_id = np.cumsum(has_aux) - 1
    pos_or_aux = np.where(
        counts > aux_cols, np.uint32(POS_AMBIGUOUS), aux_id.astype(np.uint32))
    return uniq, first, counts, pos_or_aux, flag, has_aux


def _build_ref_rows_lean(kmers: np.ndarray, pos: np.ndarray,
                         aux_cols: int, aux_base: int = 0):
    """Memory-lean equivalent of _group_ambiguity + row assembly for
    SORTED input, exploiting that duplicate k-mers are a tiny minority of
    a genome: full-width temporaries are limited to two bool masks and the
    output arrays themselves. np.unique(return_index/counts) on 3G rows
    allocates several 24 GB int64 arrays (and re-sorts) -- it OOM'd the
    whole-genome rehearsal on a 125 GB host.

    Returns (uniq, out_pos, flag, aux_rows), aux rows numbered from
    ``aux_base``. Bit-identical to the np.unique path
    (tests/test_lean_dictgen.py)."""
    n = kmers.shape[0]
    if n == 0:
        return (kmers, pos.astype(np.uint32), np.zeros(0, np.uint8),
                np.zeros((0, aux_cols), np.uint32))
    neq = kmers[1:] != kmers[:-1]
    is_first = np.empty(n, bool)
    is_first[0] = True
    is_first[1:] = neq
    is_last = np.empty(n, bool)
    is_last[-1] = True
    is_last[:-1] = neq
    del neq
    single = is_first & is_last
    del is_last

    uniq = kmers[is_first]
    out_pos = pos[is_first].astype(np.uint32)
    flag = np.where(single[is_first], FLAG_UNAMBIGUOUS,
                    FLAG_AMBIGUOUS).astype(np.uint8)

    # rows belonging to duplicated k-mers (small): group starts + counts
    dup_rows = np.flatnonzero(~single)
    del single
    if dup_rows.size:
        df = is_first[dup_rows]
        starts_in_dup = np.flatnonzero(df)
        group_row = dup_rows[df]                      # absolute first rows
        counts_dup = np.diff(np.append(starts_in_dup, dup_rows.size))
        # unique-array index of each dup group: rank of its first row
        # among all firsts, computed with a CHUNKED popcount pass (no
        # n-wide cumsum/int64 arrays)
        ui = _rank_at(is_first, group_row)
        has_aux = counts_dup <= aux_cols
        aux_id = np.cumsum(has_aux, dtype=np.int64) - 1 + aux_base
        out_pos[ui] = np.where(has_aux, aux_id,
                               np.int64(POS_AMBIGUOUS)).astype(np.uint32)
        # flag already AMBIGUOUS for these groups
        g = group_row[has_aux]
        c = counts_dup[has_aux]
        m = g.shape[0]
        aux = np.zeros((m, aux_cols), np.uint32)
        col = np.arange(aux_cols)
        idx = np.minimum(g[:, None] + col[None, :], n - 1)
        valid = col[None, :] < c[:, None]
        aux[valid] = pos[idx][valid]
    else:
        aux = np.zeros((0, aux_cols), np.uint32)
    return uniq, out_pos, flag, aux


def _rank_at(mask: np.ndarray, positions: np.ndarray,
             chunk: int = 1 << 26) -> np.ndarray:
    """count of True in mask[:p] for each (sorted ascending) position p,
    in O(len/chunk) passes with O(chunk) extra memory."""
    out = np.empty(positions.shape[0], np.int64)
    total = 0
    j = 0
    n = mask.shape[0]
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        hi = np.searchsorted(positions, e, side="left")
        if hi > j:
            local = np.cumsum(mask[s:e], dtype=np.int64)
            p = positions[j:hi]
            out[j:hi] = total + np.where(p > s, local[p - s - 1], 0)
            j = hi
        total += int(np.count_nonzero(mask[s:e]))
        if j >= positions.shape[0] and s + chunk < n:
            # remaining chunks only needed for `total`, which no one reads
            break
    return out


def _aux_rows(first, counts, sel, values, aux_cols, dtype):
    """Gather zero-padded aux rows of ``values`` for selected groups."""
    f = first[sel]
    c = counts[sel]
    m = f.shape[0]
    out = np.zeros((m, aux_cols), dtype=dtype)
    col = np.arange(aux_cols)
    idx = f[:, None] + col[None, :]
    valid = col[None, :] < c[:, None]
    idx = np.minimum(idx, values.shape[0] - 1)
    out[valid] = values[idx][valid]
    return out


REF_BUCKET_BYTES = 1 << 30   # a bucket's sort scratch (12 B a row)


def ref_buckets(rows: int) -> int:
    """The power-of-two count of key-prefix buckets that keeps a bucket's
    sort scratch near REF_BUCKET_BYTES for ``rows`` uniformly spread keys
    (at most 2**16)."""
    need = -(-rows * 12 // REF_BUCKET_BYTES)
    return min(1 << max(need - 1, 0).bit_length(), 1 << 16)


def _kmer_chunks(codes: np.ndarray, ch: int):
    """(start, rolling k-mers, valid) over ``ch``-base chunks of ``codes``
    (31 bases of overlap)."""
    from .. import native

    n = codes.shape[0]
    for s0 in range(0, max(n - 31, 0), ch):
        e0 = min(s0 + ch + 31, n)
        if native.available() and (e0 - s0) > 4096:
            roll, ok = native.rolling_kmers(codes[s0:e0])
        else:
            roll = np_rolling_kmers_u64(codes[s0:e0])
            ok = ~np_window_has_n(codes[s0:e0])
        yield s0, roll, ok


def _sort_kv(keys: np.ndarray, vals: np.ndarray) -> None:
    """Stable in-place sort of (keys, vals) by key."""
    from .. import native

    n = keys.shape[0]
    if n >= (1 << 16) and n < (1 << 32) and native.available() \
            and native.radix_sort_kv(keys, vals):
        return
    order = np.argsort(keys, kind="stable")
    keys[:] = keys[order]
    vals[:] = vals[order]


def build_ref_dict(seqs: List[Seq], aux_cols: int = AUX_TABLE_COLS_DEF
                   ) -> Tuple[RefDict, int]:
    """Build the reference dictionary from dict-parser-normalized sequences.

    Positions are 1-based offsets into the concatenation of all chromosomes
    in FASTA order (src/dictgen.c:289, 303-320). Returns (dict, max_pos),
    equal to the JAX ``build_ref_dict``'s.

    Built in ``ref_buckets`` buckets of the key's top bits. Equal keys
    share a bucket, and each bucket is filled in genome order, so a stable
    sort of each bucket and the buckets in turn give the order of one
    global stable sort; aux rows are numbered across buckets. Holds the
    keys and positions once (12 B a row), one bucket's sort scratch, and a
    1 B flag a row; the rows are compacted in place."""
    upper = sum(s.size - 31 for s in seqs if s.size >= 32)
    nb = ref_buckets(upper)
    bits = nb.bit_length() - 1
    shift = np.uint64(64 - bits)
    CH = 1 << 25

    def bucket_of(keys):
        return (keys >> shift).astype(np.uint16)

    counts = np.zeros(nb, np.int64)
    for s in seqs:
        if s.size >= 32:
            for _s0, roll, ok in _kmer_chunks(s.codes_normalized(), CH):
                if nb == 1:
                    counts[0] += int(np.count_nonzero(ok))
                else:
                    counts += np.bincount(bucket_of(roll[ok]), minlength=nb)
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    total = int(starts[-1])

    kmers = np.empty(total, np.uint64)
    pos = np.empty(total, np.uint32)
    cursor = starts[:-1].copy()
    index = 1  # 1-based global position cursor
    for s in seqs:
        if s.size >= 32:
            for s0, roll, ok in _kmer_chunks(s.codes_normalized(), CH):
                sel = np.flatnonzero(ok)
                key = roll[sel]
                p = (sel + (index + s0)).astype(np.uint32)
                del sel
                if nb == 1:
                    c = np.array([key.shape[0]])
                else:
                    b = bucket_of(key)
                    order = np.argsort(b, kind="stable")
                    c = np.bincount(b, minlength=nb)
                    key, p = key[order], p[order]
                    del b, order
                off = 0
                for j in np.flatnonzero(c):
                    m, w = int(c[j]), int(cursor[j])
                    kmers[w:w + m] = key[off:off + m]
                    pos[w:w + m] = p[off:off + m]
                    cursor[j] += m
                    off += m
        index += s.size
    assert np.array_equal(cursor, starts[1:])

    flag = np.empty(total, np.uint8)
    aux_parts = []
    n_aux = 0
    w = 0
    max_pos = 0
    for j in range(nb):
        a, e = int(starts[j]), int(starts[j + 1])
        if a == e:
            continue
        k, p = kmers[a:e], pos[a:e]
        max_pos = max(max_pos, int(p.max()))
        _sort_kv(k, p)
        uniq, out_pos, fl, aux = _build_ref_rows_lean(k, p, aux_cols,
                                                      aux_base=n_aux)
        del k, p
        u = uniq.shape[0]
        kmers[w:w + u] = uniq
        pos[w:w + u] = out_pos
        flag[w:w + u] = fl
        del uniq, out_pos, fl
        w += u
        n_aux += aux.shape[0]
        aux_parts.append(aux)
    for a in (kmers, pos, flag):   # no view of them is left
        a.resize(w, refcheck=False)
    aux = (np.concatenate(aux_parts) if aux_parts
           else np.zeros((0, aux_cols), np.uint32))
    return RefDict(kmers=kmers, pos=pos, flag=flag, aux=aux), max_pos


def _find_seq_by_name(seqs: List[Seq], name: str):
    """find_seq_by_name (src/dictgen.c:303-320): dict-style names; returns
    (seq, 1-based global start index) or (None, 0)."""
    start = 1
    for s in seqs:
        if s.name == name:
            return s, start
        start += s.size
    return None, 0


class VcfRefMismatch(RuntimeError):
    pass


def build_snp_dict_from_vcf(
    seqs: List[Seq], vcf_path: str, aux_cols: int = AUX_TABLE_COLS_DEF
) -> Tuple[SnpDict, np.ndarray]:
    """Build the SNP dictionary from a VCF (src/dictgen.c:561-785).

    Returns (SnpDict, snp_locations bool array) where snp_locations[loc] is
    True for every retained SNP's 1-based global position (used by `filt`).

    Per VCF data row, in order:
      - REF base must encode to A/C/G/T (BASE_X skip, src/dictgen.c:637);
      - REF and ALT columns must be single characters (641-652);
      - chromosome matched by dict-style name, with 'chr' prefixed when the
        FASTA names start with 'c' and the VCF name doesn't (596-633);
      - genome base at POS must equal REF (normalized uppercase) else the
        whole build fails (666-672);
      - POS must admit 32 covering k-mers (674);
      - ALT must be A/C/G/T and differ from REF (684-696, 747-749);
      - CAF= allele freqs parsed with cross-line persistence (707-735);
      - the 32 alt-substituted k-mers are generated by one left-flank encode
        plus 32 rolling shifts, aborting the row when any base is N (753-772).
    """
    normalized = {}  # chrom name -> uint8 codes cache

    def norm_codes(s: Seq) -> np.ndarray:
        r = normalized.get(id(s))
        if r is None:
            r = s.codes_normalized()
            normalized[id(s)] = r
        return r

    snp_locs: List[int] = []

    ref_has_chr = bool(seqs) and seqs[0].name.startswith("c")
    caf = CafExtractor()
    chrom: Seq | None = None
    chrom_start = 1
    base_code = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}

    # Candidate rows passing every scalar filter; the N-window checks and
    # the 32 covering alt-substituted k-mers (src/dictgen.c:753-772) are
    # evaluated AFTER the scan, vectorized per chromosome over the
    # chromosome's rolling-kmer array -- the per-row 32-step build was the
    # build's hot loop at dbSNP scale. Row order is preserved exactly
    # (results land at each candidate's scan position), which the stable
    # kmer sort below depends on for aux-position generation order.
    c_seq: List[Seq] = []
    c_start: List[int] = []
    c_index: List[int] = []
    c_ref: List[int] = []
    c_alt: List[int] = []
    c_rf: List[int] = []
    c_af: List[int] = []

    for row in iter_vcf_rows(vcf_path):
        chrom_name = row.chrom
        if not chrom_name.startswith("c") and ref_has_chr:
            chrom_name = "chr" + chrom_name

        ref_ch = row.ref[:1].upper()
        ref_u = base_code.get(ref_ch, BASE_X)
        if ref_u == BASE_X:
            continue
        if len(row.ref) != 1 or len(row.alt) != 1:
            # single-base check via the char after the field (641-652)
            continue

        if chrom is None or chrom.name != chrom_name:
            chrom, chrom_start = _find_seq_by_name(seqs, chrom_name)
            if chrom is None:
                continue

        index = row.pos1 - 1  # 0-based within chromosome
        codes = norm_codes(chrom)
        # genome base (normalized to ACGTN) must equal the REF base; any
        # mismatch aborts the whole build (src/dictgen.c:666-672)
        if index >= chrom.size or codes[index] != ref_u:
            raise VcfRefMismatch(
                f"Mismatch between reference and SNP file at 0-based "
                f"index {index} in {chrom.name}")
        if index < 32 or (index + 32) > chrom.size:
            continue

        alt_ch = row.alt[:1].upper()
        if ref_ch not in "ACGT":
            continue  # e.g. REF=N passed the X-check but fails here (686)
        if alt_ch not in "ACGT":
            continue
        # a1 == ref always here; mark the SNP location (698-705)
        snp_locs.append(chrom_start + index)

        f1, f2 = caf.extract(row.info)

        if alt_ch == ref_ch:
            continue

        c_seq.append(chrom)
        c_start.append(chrom_start)
        c_index.append(index)
        c_ref.append(ref_u)
        c_alt.append(base_code[alt_ch])
        c_rf.append(encode_freq(f1))
        c_af.append(encode_freq(f2))

    n_cand = len(c_index)
    idx_a = np.asarray(c_index, np.int64) if n_cand else np.zeros(0, np.int64)
    start_a = np.asarray(c_start, np.int64) if n_cand \
        else np.zeros(0, np.int64)
    ref_a = np.asarray(c_ref, np.uint8) if n_cand else np.zeros(0, np.uint8)
    alt_a = np.asarray(c_alt, np.uint64) if n_cand \
        else np.zeros(0, np.uint64)
    rf_a = np.asarray(c_rf, np.uint8) if n_cand else np.zeros(0, np.uint8)
    af_a = np.asarray(c_af, np.uint8) if n_cand else np.zeros(0, np.uint8)

    keep = np.zeros(n_cand, bool)
    kk_all = np.zeros((n_cand, 32), np.uint64)
    seq_ids = {}
    for i, s in enumerate(c_seq):
        seq_ids.setdefault(id(s), (s, []))[1].append(i)
    jj = np.arange(32, dtype=np.int64)
    off_bits = (np.uint64(2) * (np.uint64(31) - jj.astype(np.uint64)))
    clear_mask = ~(np.uint64(3) << off_bits)           # (32,)
    around = np.arange(-32, 32, dtype=np.int64)         # bases ii-32..ii+31
    for s, rows_l in seq_ids.values():
        codes = norm_codes(s)
        for r0 in range(0, len(rows_l), 1 << 20):
            rows_a = np.asarray(rows_l[r0:r0 + (1 << 20)], np.int64)
            win = codes[idx_a[rows_a, None] + around[None, :]]   # (r, 64)
            bad = win > 3
            # window[:32] N-free, and the rest excluding the SNP base
            ok = ~bad[:, :32].any(1) & ~bad[:, 33:].any(1)
            del bad
            keep[rows_a] = ok
            rows_ok = rows_a[ok]
            if rows_ok.size == 0:
                continue
            # the 32 covering k-mers: base t of a window at bits 2t, as
            # the rolling k-mers have them
            w = win[ok, 1:].astype(np.uint64)                  # (r, 63)
            del win
            k = np.zeros(rows_ok.shape[0], np.uint64)
            for t in range(32):
                k |= w[:, t] << np.uint64(2 * t)
            kk = np.empty((rows_ok.shape[0], 32), np.uint64)
            kk[:, 0] = k
            for j in range(1, 32):
                k = (k >> np.uint64(2)) | (w[:, j + 31] << np.uint64(62))
                kk[:, j] = k
            kk_all[rows_ok] = ((kk & clear_mask[None, :])
                               | (alt_a[rows_ok, None] << off_bits[None, :]))

    rows_keep = np.flatnonzero(keep)
    kmers = kk_all[rows_keep].reshape(-1)
    i_arr = np.arange(32, dtype=np.uint32)
    pos = ((start_a[rows_keep, None] + idx_a[rows_keep, None] - 31
            + i_arr[None, :]).astype(np.uint32).reshape(-1))
    snp = (((np.uint32(31) - i_arr[None, :]) << np.uint32(3)
            | ref_a[rows_keep, None].astype(np.uint32))
           .astype(np.uint8).reshape(-1))
    rf = np.repeat(rf_a[rows_keep], 32)
    af = np.repeat(af_a[rows_keep], 32)

    order = _stable_argsort_u64(kmers)
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
    aux_kmer = uniq[has_aux]

    locs = np.zeros(max(snp_locs) + 1 if snp_locs else 10, dtype=bool)
    for l in snp_locs:
        locs[l] = True

    return (
        SnpDict(kmers=uniq, pos=out_pos, snp=out_snp, flag=flag,
                ref_freq=out_rf, alt_freq=out_af, aux_kmer=aux_kmer,
                aux_pos=aux_pos, aux_snp=aux_snp, aux_rf=aux_rf,
                aux_af=aux_af),
        locs,
    )
