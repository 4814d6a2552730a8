"""Jax-free copy of ``vargeno_tpu/engine/pileup_compact.py``.

PCOMPACT pileup variant: the reference's chained hash map, host-side.

The reference ships with PCOMPACT=0 (flat array pileup, src/vartype.h:9);
with PCOMPACT=1 it instead keys pileup entries by genome position in a
java.util.HashMap-style chained hash table (src/pileup.{h,c}): hash
``h ^= (h>>20)^(h>>12); h ^ (h>>7) ^ (h>>4)`` masked to a power-of-two
size, load factor 0.4, x2 growth, insert-at-head chaining, first-insert
wins (ptable_add returns early when the key exists, pileup.c:63-66).

On the device the engine's site tensors already ARE the compact
representation (only real SNP sites get rows -- engine/device_index.py
site_* arrays), so this class exists for reference-surface completeness
and as the oracle for PCOMPACT semantics: iteration ORDER differs from the
flat table (the reference's call loop walks positions 0..max either way,
qv.cc:1573, so outputs are identical -- asserted in
tests/test_torch_pileup_compact.py).
"""

from __future__ import annotations


def _hash(h: int) -> int:
    h &= 0xFFFFFFFF
    h ^= ((h >> 20) ^ (h >> 12))
    return (h ^ (h >> 7) ^ (h >> 4)) & 0xFFFFFFFF


class PileupTableCompact:
    """Faithful model of src/pileup.c (chains modeled as insert-at-head
    Python lists per bucket)."""

    LOAD_FACTOR = 0.4

    def __init__(self, size: int = 1 << 25):
        assert size & (size - 1) == 0, "size must be a power of 2"
        self.size = size
        self.count = 0
        self.threshold = int(size * self.LOAD_FACTOR)
        self.table: list = [None] * size
        self._entries: dict = {}   # key -> entry (fast get; same semantics)

    def get(self, key: int):
        """Entry dict with ref/alt/ref_cnt/alt_cnt/ref_freq/alt_freq or
        None (ptable_get, pileup.h:36-47)."""
        return self._entries.get(key)

    def add(self, key: int, ref: int, alt: int,
            ref_freq: int, alt_freq: int) -> None:
        """ptable_add (pileup.c:61-88): first insert wins; counts start 0;
        grow at count > threshold."""
        if key in self._entries:
            return
        e = dict(key=key, ref=ref & 3, alt=alt & 3, ref_cnt=0, alt_cnt=0,
                 ref_freq=ref_freq & 0xFF, alt_freq=alt_freq & 0xFF)
        n = _hash(key) & (self.size - 1)
        bucket = self.table[n]
        self.table[n] = (e, bucket)   # insert at head (pileup.c:80-81)
        self._entries[key] = e
        self.count += 1
        if self.count > self.threshold:
            self._grow()

    def _grow(self) -> None:
        """x2 rehash preserving the reference's relink order
        (pileup.c:34-58: walking each chain head-first and inserting at
        the new head REVERSES chain order; modeled identically)."""
        new_size = 2 * self.size
        new_table: list = [None] * new_size
        for i in range(self.size):
            node = self.table[i]
            while node is not None:
                e, nxt = node
                n = _hash(e["key"]) & (new_size - 1)
                new_table[n] = (e, new_table[n])
                node = nxt
        self.table = new_table
        self.size = new_size
        self.threshold = int(new_size * self.LOAD_FACTOR)

    def bump(self, key: int, is_ref: bool, max_cov: int = 63) -> None:
        """Saturating count update (qv.cc:1409-1424 under PCOMPACT)."""
        e = self._entries.get(key)
        if e is None:
            return
        f = "ref_cnt" if is_ref else "alt_cnt"
        if e[f] != max_cov:
            e[f] += 1

    def chain_of(self, key: int):
        """Bucket chain (key order) -- exposes the modeled structure for
        structural tests."""
        out = []
        node = self.table[_hash(key) & (self.size - 1)]
        while node is not None:
            out.append(node[0]["key"])
            node = node[1]
        return out
