"""The port's PCOMPACT pileup model (``engine/pileup_compact.py``) against
the JAX package's class: the same hashes, and after the same sequence of
adds and bumps (from a numpy seed) the same counts, entries, chain order
and growth points."""

import numpy as np
from torch_index_share import small_index

from vargeno_tpu.engine.pileup_compact import PileupTableCompact as JTable
from vargeno_tpu.engine.pileup_compact import _hash as j_hash
from vargeno_tpu_torch.engine.pileup_compact import (PileupTableCompact,
                                                     _hash)


def _walk(t):
    """Every entry in iteration order: bucket by bucket, chain head
    first."""
    out = []
    for node in t.table:
        while node is not None:
            out.append(dict(node[0]))
            node = node[1]
    return out


def test_hash_matches_jax():
    rng = np.random.default_rng(3)
    keys = [0, 1, 0xFFFFFFFF, 1 << 32, (1 << 40) + 7]
    keys += rng.integers(0, 2**40, 2000, dtype=np.uint64).tolist()
    assert [_hash(int(k)) for k in keys] == [j_hash(int(k)) for k in keys]


def test_same_adds_same_table():
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 2**32, 1500, dtype=np.uint64)
    t, j = PileupTableCompact(size=8), JTable(size=8)
    growth = []
    for step in range(4000):
        key = int(pool[rng.integers(0, pool.size)])
        if rng.random() < 0.6:
            ref, alt, rf, af = (int(v) for v in rng.integers(0, 512, 4))
            t.add(key, ref, alt, rf, af)
            j.add(key, ref, alt, rf, af)
        else:
            is_ref = bool(rng.random() < 0.5)
            t.bump(key, is_ref)
            j.bump(key, is_ref)
        assert (t.size, t.count, t.threshold) == (j.size, j.count,
                                                  j.threshold)
        if not growth or growth[-1][1] != t.size:
            growth.append((step, t.size))
    assert len(growth) > 5   # the table grew several times on the way
    assert _walk(t) == _walk(j)
    for key in pool.tolist():
        assert t.get(key) == j.get(key)
        assert t.chain_of(key) == j.chain_of(key)
    assert sum(e["ref_cnt"] + e["alt_cnt"] for e in _walk(t)) > 0


def test_first_insert_wins_and_counts_saturate():
    t = PileupTableCompact(size=8)
    t.add(100, 1, 2, 200, 55)
    t.add(100, 3, 0, 1, 1)
    e = t.get(100)
    assert (e["ref"], e["alt"], e["ref_freq"], e["alt_freq"]) == (1, 2, 200,
                                                                  55)
    for _ in range(100):
        t.bump(100, True)
    assert t.get(100)["ref_cnt"] == 63 and t.get(100)["alt_cnt"] == 0
    assert t.get(999) is None


def test_compact_table_holds_the_index_sites():
    """Seeded from the mini index's sites (qv.cc:637-660 under PCOMPACT),
    the table holds the same site set, alleles and frequencies as the flat
    site arrays the engine uses, in the JAX class's order."""
    s = small_index().sites
    t, j = PileupTableCompact(size=1 << 10), JTable(size=1 << 10)
    for p, r, a, rf, af in zip(s.pos, s.ref, s.alt, s.rf, s.af):
        t.add(int(p), int(r), int(a), int(rf), int(af))
        j.add(int(p), int(r), int(a), int(rf), int(af))
    assert t.count == s.pos.shape[0]
    for p, r, a, rf, af in zip(s.pos, s.ref, s.alt, s.rf, s.af):
        e = t.get(int(p))
        assert (e["ref"], e["alt"], e["ref_freq"], e["alt_freq"]) == \
            (int(r) & 3, int(a) & 3, int(rf) & 0xFF, int(af) & 0xFF)
    assert _walk(t) == _walk(j)
