"""The reference's genotyping: VarGeno's ``geno`` loop (qv.cc:475-1848)
read by read, over the reference's own index (``reference.index``). A
frozen restatement of the sequential specification, kept apart from the
program: it imports nothing of it.

Per read, forward first and the reverse complement of its first
32 * floor(len / 32) bases only if the forward pass is not processed:

- each k-mer is looked up exactly in both dictionaries (a binary search
  of the full key);
- a k-mer whose quality character (the quality string at the k-mer's
  index, never reversed) is below '8' also gets its Hamming-1 neighbours:
  the low 16 bases by enumeration when its reference block (keys sharing
  the high 32 bits) holds 100 rows or more, else by scanning that block
  and the SNP block (keys sharing the high 24 bits), with the reference's
  stride bug (the test reads entry ``lo + 9 * (i - lo)``, ``lo + 11 * (i -
  lo)`` for SNP rows, zero past the end); the high 16 bases by enumeration,
  pruned by the Bloom filters (reference probes only on a reference-filter
  hit, SNP probes above base 20 only on a SNP-filter hit);
- neighbour hits at a known site (reference rows) or that mutate the SNP
  itself (SNP rows) are dropped;
- the vote: a position counts once a second distinct k-mer position
  supports it; neighbour hits only add to positions already seen; the best
  is strictly more frequent, a tie makes it ambiguous;
- a processed read adds, for every context at the voted position, each of
  its 32 bases (but a neighbour's mutated one) to the site there, counting
  REF or ALT matches up to 63.

``neighbors=False`` leaves the Hamming-1 search out: the control that
breaks the configuration's guarantee of the reference's neighbour search.
"""

from __future__ import annotations

import numpy as np

from .index import FLAG_UNAMBIGUOUS, POS_AMBIGUOUS, Index, hash32, hash40

U32 = 0xFFFFFFFF
LO40 = 0xFF_FFFF_FFFF
NO_MODIFICATION = 10086
QUALITY_SCORE = ord("8")
BLOCK_SIZE_THRESHOLD = 100
MAX_COV = 63
CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def hamming1(x: int):
    """The base index of a XOR confined to one 2-bit field, else None."""
    if x == 0:
        return None
    k = ((x & -x).bit_length() - 1) // 2
    return None if x & ~(3 << (2 * k)) else k


class Oracle:
    def __init__(self, index: Index, neighbors: bool = True):
        self.ix = index
        self.neighbors = neighbors
        # site position -> [ref, alt, ref count, alt count]
        self.pileup = {int(p): [int(r), int(a), 0, 0] for p, r, a in zip(
            index.site_pos, index.site_ref, index.site_alt)}

    def _find(self, keys, k: int) -> int:
        i = int(keys.searchsorted(np.uint64(k)))
        return i if i < keys.shape[0] and int(keys[i]) == k else -1

    def _block(self, keys, k: int, shift: int):
        h = k >> shift
        return (int(keys.searchsorted(np.uint64(h << shift))),
                int(keys.searchsorted(np.uint64(((h + 1) << shift) - 1),
                                      "right")))

    def _is_site(self, pos: int) -> bool:
        e = self.pileup.get(pos)
        return e is not None and not (e[0] == 0 and e[1] == 0)

    def process_read(self, seq: str, qual: str) -> None:
        length = len(seq) // 32 * 32
        for oriented in (seq, "".join(COMP[c] for c in reversed(
                seq[:length]))):
            kmers = []
            for i in range(0, length, 32):
                k = 0
                for j in range(32):
                    k |= CODE[oriented[i + j]] << (2 * j)
                kmers.append(k)
            ok, target, ctx = self._oriented(kmers, qual)
            if ok:
                self._accumulate(target, ctx)
                return

    def _oriented(self, kmers, qual):
        ix = self.ix
        freq, support = {}, {}
        state = {"best": None, "amb": False}
        ctx = []   # (kmer, read position, k-mer position, modified base)

        def add(rp, kp, neighbor):
            if neighbor and rp not in support:
                return
            freq[rp] = freq.get(rp, 0) + 1
            support.setdefault(rp, set()).add(kp)
            if len(support[rp]) <= 1:
                return
            best = state["best"]
            if best is None or rp == best:
                state["best"], state["amb"] = rp, False
            elif freq[rp] == freq[best]:
                state["amb"] = True
            elif freq[rp] > freq[best]:
                state["best"], state["amb"] = rp, False

        def positions(pos, flag, aux_pos, aux_snp, row):
            p = int(pos[row])
            if p == POS_AMBIGUOUS:
                return []
            if flag[row] == FLAG_UNAMBIGUOUS:
                return [(p, row, None)]
            out = []
            for c in range(aux_pos.shape[1]):
                q = int(aux_pos[p, c])
                if q == 0:
                    break
                out.append((q, None, None if aux_snp is None
                            else int(aux_snp[p, c])))
            return out

        def ref_hit(row, kmer, off, diff=None):
            for p, _, _ in positions(ix.ref_pos, ix.ref_flag, ix.ref_aux,
                                     None, row):
                if diff is not None and self._is_site(p + diff):
                    continue
                rp = (p - off) & U32
                ctx.append((kmer, rp, p, NO_MODIFICATION if diff is None
                            else diff))
                add(rp, p, diff is not None)

        def snp_hit(row, kmer, off, diff=None):
            for p, r, s in positions(ix.snp_pos, ix.snp_flag, ix.snp_aux_pos,
                                     ix.snp_aux_snp, row):
                info = int(ix.snp_info[r]) if r is not None else s
                if diff is not None and ((info >> 3) & 0x1F) == diff:
                    continue
                rp = (p - off) & U32
                ctx.append((kmer, rp, p, NO_MODIFICATION if diff is None
                            else diff))
                add(rp, p, diff is not None)

        for i, kmer in enumerate(kmers):
            off = 32 * i
            r = self._find(ix.ref_kmers, kmer)
            s = self._find(ix.snp_kmers, kmer)
            blo, bhi = self._block(ix.ref_kmers, kmer, 32)
            if r >= 0:
                ref_hit(r, kmer, off)
            if s >= 0:
                snp_hit(s, kmer, off)
            if not self.neighbors or ord(qual[i]) >= QUALITY_SCORE:
                continue
            bit = int(hash32(np.uint32(kmer & U32))) % ix.ref_bf.bits
            ref_bound = 64 if ix.ref_bf.test_bits([bit])[0] else 32
            bit = int(hash40(np.uint64(kmer & LO40)) % np.uint64(
                ix.snp_bf.bits))
            snp_bound = 64 if ix.snp_bf.test_bits([bit])[0] else 40
            big = bhi - blo >= BLOCK_SIZE_THRESHOLD
            if big:
                for b in range(0, 32, 2):
                    base = (kmer >> b) & 3
                    for j in range(4):
                        if j == base:
                            continue
                        nb = (kmer & ~(3 << b)) | (j << b)
                        rr = self._find(ix.ref_kmers, nb)
                        ss = self._find(ix.snp_kmers, nb)
                        if rr >= 0:
                            ref_hit(rr, nb, off, b // 2)
                        if ss >= 0:
                            snp_hit(ss, nb, off, b // 2)
            else:
                n_ref = ix.ref_kmers.shape[0]
                for row in range(blo, bhi):
                    t = blo + 9 * (row - blo)
                    lo = int(ix.ref_kmers[t]) & U32 if t < n_ref else 0
                    d = hamming1((kmer & U32) ^ lo)
                    if d is not None:
                        ref_hit(row, (kmer >> 32 << 32) | lo, off, d)
                slo, shi = self._block(ix.snp_kmers, kmer, 40)
                n_snp = ix.snp_kmers.shape[0]
                for row in range(slo, shi):
                    t = slo + 11 * (row - slo)
                    lo = int(ix.snp_kmers[t]) & LO40 if t < n_snp else 0
                    d = hamming1((kmer & LO40) ^ lo)
                    if d is not None:
                        snp_hit(row, (kmer >> 40 << 40) | lo, off, d)
            for b in range(32, 64, 2):
                base = (kmer >> b) & 3
                for j in range(4):
                    if j == base:
                        continue
                    nb = (kmer & ~(3 << b)) | (j << b)
                    if b < ref_bound:
                        rr = self._find(ix.ref_kmers, nb)
                        if rr >= 0:
                            ref_hit(rr, nb, off, b // 2)
                    if (big or b >= 40) and b < snp_bound:
                        ss = self._find(ix.snp_kmers, nb)
                        if ss >= 0:
                            snp_hit(ss, nb, off, b // 2)

        best = state["best"]
        ok = best is not None and freq[best] > 1 and not state["amb"]
        return ok, best, ctx

    def _accumulate(self, target, ctx) -> None:
        for kmer, rp, kp, modified in ctx:
            if rp != target:
                continue
            for i in range(32):
                if i == modified:
                    continue
                e = self.pileup.get(kp + i)
                if e is None or e[0] == e[1]:
                    continue
                base = (kmer >> (2 * i)) & 3
                if base == e[0]:
                    e[2] = min(e[2] + 1, MAX_COV)
                elif base == e[1]:
                    e[3] = min(e[3] + 1, MAX_COV)

    def counts(self, positions) -> np.ndarray:
        """(n, 2) REF / ALT counts at the given site positions."""
        return np.array([self.pileup[int(p)][2:4] for p in positions],
                        np.int64).reshape(-1, 2)
