"""Which sites the reference checks, and which reads can touch them.

A read adds to the site at position ``s`` only through a context whose
k-mer position ``p`` (a dictionary row's position, or one of its aux
positions) lies in ``[s - 31, s]``. Such a row is reached from one of the
read's k-mers (either orientation) only by:

- an exact lookup: the k-mer equals the row's key;
- a Hamming-1 neighbour (low-quality k-mers only): the key differs in one
  base, so it shares the k-mer's high 32 bits or its low 32 bits;
- a reference block scan (low-quality k-mers only): the key shares the
  k-mer's high 32 bits;
- a SNP block scan (low-quality k-mers only): the key shares the k-mer's
  high 24 bits.

So a read none of whose k-mers meets one of those tests against the rows
near the sampled sites leaves their counts as they are, and the oracle
runs only over the reads that do.
"""

from __future__ import annotations

import numpy as np

from .index import FLAG_UNAMBIGUOUS, POS_AMBIGUOUS, U64, Index, sorted_unique
from .oracle import QUALITY_SCORE

CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i
COMP = np.array([3, 2, 1, 0], np.uint8)


def sample_sites(index: Index, n: int, seed: int) -> np.ndarray:
    """Sorted positions of ``n`` sites (all of them when fewer) drawn
    from ``seed``."""
    rng = np.random.default_rng([seed, 0x5173])
    if n >= index.site_pos.shape[0]:
        return index.site_pos.copy()
    pick = rng.choice(index.site_pos.shape[0], n, replace=False)
    return np.sort(index.site_pos[pick])


def _near_mask(sites: np.ndarray) -> np.ndarray:
    """By position p: whether a site lies in [p, p + 31]."""
    edge = np.zeros(int(sites.max()) + 2, np.int32)
    np.add.at(edge, np.maximum(sites - 31, 0), 1)
    np.add.at(edge, sites + 1, -1)
    return np.cumsum(edge) > 0


def _near(positions: np.ndarray, mask: np.ndarray) -> np.ndarray:
    p = np.minimum(positions.astype(np.int64), mask.shape[0] - 1)
    return mask[p]


def _near_rows(pos, flag, aux, mask) -> np.ndarray:
    """Rows of a dictionary with a position near a site."""
    unamb = (flag == FLAG_UNAMBIGUOUS) & (pos != POS_AMBIGUOUS)
    hit = unamb & _near(pos, mask)
    has_aux = (flag != FLAG_UNAMBIGUOUS) & (pos != POS_AMBIGUOUS)
    rows = np.flatnonzero(has_aux)
    a = aux[pos[rows].astype(np.int64)]
    hit[rows] = ((a != 0) & _near(a.reshape(-1), mask).reshape(a.shape)
                 ).any(1)
    return np.flatnonzero(hit)


class Keys:
    """The tests of the module docstring against the rows near ``sites``."""

    def __init__(self, index: Index, sites: np.ndarray):
        mask = _near_mask(sites)
        r = index.ref_kmers[_near_rows(index.ref_pos, index.ref_flag,
                                       index.ref_aux, mask)]
        s = index.snp_kmers[_near_rows(index.snp_pos, index.snp_flag,
                                       index.snp_aux_pos, mask)]
        both = np.concatenate([r, s])
        m32 = U64(0xFFFFFFFF)
        self.exact = sorted_unique(both)
        self.hi32 = sorted_unique(both >> U64(32))
        self.lo32 = sorted_unique(both & m32)
        self.hi24 = sorted_unique(s >> U64(40))

    def reads(self, kmers: np.ndarray, low: np.ndarray) -> np.ndarray:
        """Per read, whether any of its k-mers (R, S) with their
        low-quality flags (R, S) can reach a near row."""
        hit = member(kmers, self.exact)
        k = kmers[low]
        hit[low] |= (member(k >> U64(32), self.hi32)
                     | member(k & U64(0xFFFFFFFF), self.lo32)
                     | member(k >> U64(40), self.hi24))
        return hit.any(1)


def member(x: np.ndarray, sorted_set: np.ndarray) -> np.ndarray:
    """x in the sorted, unique ``sorted_set``, elementwise."""
    if sorted_set.size == 0:
        return np.zeros(x.shape, bool)
    i = np.minimum(np.searchsorted(sorted_set, x), sorted_set.size - 1)
    return sorted_set[i] == x


def fastq_records(path: str):
    """(seqs (n, L) uint8 ASCII, quals (n, L) uint8) of a FASTQ whose
    records all have one length (the benchmark's)."""
    with open(path, "rb") as f:
        data = f.read()
    first = data.split(b"\n", 4)
    width = sum(len(x) + 1 for x in first[:4])
    L = len(first[1])
    if len(data) % width:
        raise ValueError(f"{path}: records are not all {width} bytes")
    rec = np.frombuffer(data, np.uint8).reshape(-1, width)
    o = len(first[0]) + 1
    if not ((rec[:, 0] == ord("@")).all() and (rec[:, o + L + 1] == ord("+"))
            .all() and (rec[:, -1] == ord("\n")).all()):
        raise ValueError(f"{path}: not fixed-width FASTQ records")
    return rec[:, o:o + L], rec[:, o + L + 3:o + 2 * L + 3]


def read_kmers(seqs: np.ndarray, quals: np.ndarray):
    """(k-mers (n, 2K) uint64, low-quality flags (n, 2K)): each read's K =
    L // 32 forward k-mers, then those of the reverse complement of its
    first 32 K bases; the flag of k-mer i is quality character i < '8'
    in both orientations."""
    codes = CODE[seqs]
    if (codes > 3).any():
        raise ValueError("reads must be ACGT only")
    K = seqs.shape[1] // 32
    rc = COMP[codes[:, :32 * K][:, ::-1]]
    out = np.zeros((seqs.shape[0], 2 * K), U64)
    for o, src in enumerate((codes, rc)):
        # four bases a byte (base t at bits 2t), eight bytes a k-mer
        q = src[:, :32 * K].reshape(src.shape[0], 8 * K, 4)
        b = q[..., 0] | q[..., 1] << 2 | q[..., 2] << 4 | q[..., 3] << 6
        out[:, o * K:(o + 1) * K] = np.ascontiguousarray(b).view("<u8")
    low = np.tile(quals[:, :K] < QUALITY_SCORE, 2)
    return out, low
