"""Bucketized open-addressing hash table for exact k-mer lookups (port of
``vargeno_tpu/engine/hashtable.py`` build_hash_table / ht_lookup_both).

Keys live in 32-slot buckets, one 512-byte row per bucket, laid out
FIELD-BLOCKED: [hi x 32 | lo x 32 | pos x 32 | meta x 32] 32-bit words, with
meta = occupied<<31 | snp_info<<16 | flag. Ref and snp rows share one table;
snp rows carry tag bit 7 in the flag byte, so one chain of bucket-row
gathers answers exact membership in BOTH dictionaries.

The table is built on the host (numpy, or the native C++ build for large
key sets) and lives on the device as int32 bit patterns of the uint32
words. Lookups compare in int32 space (equality is the same on the bit
patterns) and widen only the selected pos/meta words.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.hashes import M32, as_i32, hash32, np_hash32

_MIX = 0x9E3779B9


def _bucket_hash_np(hi, lo, nb):
    with np.errstate(over="ignore"):
        h = np_hash32(lo) ^ (np_hash32(hi) * np.uint32(_MIX))
    return (h & np.uint32(nb - 1)).astype(np.int64)


@dataclasses.dataclass
class HostHashTable:
    table: np.ndarray   # (nb, 128) uint32
    nb: int
    chain: int


def build_hash_table(hi: np.ndarray, lo: np.ndarray, pos: np.ndarray,
                     flag: np.ndarray, info: np.ndarray | None,
                     slots_per_bucket: int = 32,
                     target_load: float = 0.5,
                     use_native: bool = True) -> HostHashTable:
    """Host build (same bucket count, hash and row layout as the JAX
    package's). The native build places keys by sequential insertion and
    the numpy one in rounds, so their table bytes differ; any consistent
    placement with a valid chain bound gives identical lookups."""
    n = hi.shape[0]
    nb = 1 << max(2, int(np.ceil(np.log2(
        max(n / (slots_per_bucket * target_load), 1.0)))))

    if use_native and n >= (1 << 16):
        from .. import native

        if native.available():
            table, chain = native.ht_build(hi, lo, pos, flag, info, nb,
                                           slots_per_bucket)
            return HostHashTable(table=table, nb=nb, chain=chain)

    home = _bucket_hash_np(hi, lo, nb)

    bucket = home.copy()
    placed = np.full(n, -1, np.int64)
    cap = np.zeros(nb, np.int64)
    remaining = np.arange(n)
    rounds = 0
    while remaining.size:
        b = bucket[remaining]
        order = np.argsort(b, kind="stable")
        rb = b[order]
        start = np.searchsorted(rb, rb)
        within = np.arange(rb.size) - start
        free = slots_per_bucket - cap[rb]
        fits = within < free
        sel = remaining[order[fits]]
        placed[sel] = b[order[fits]]
        np.add.at(cap, b[order[fits]], 1)
        rem = remaining[order[~fits]]
        bucket[rem] = (bucket[rem] + 1) & (nb - 1)
        remaining = rem
        rounds += 1
        if rounds > 64:
            raise RuntimeError("hash table build did not converge")

    # lookup chain bound: longest run of completely-full buckets + 1
    full = cap >= slots_per_bucket
    if full.any():
        f2 = np.concatenate([full, full])  # cover wraparound runs
        zeros = np.flatnonzero(~f2)
        if zeros.size == 0:
            best = len(f2)
        else:
            edges = np.concatenate([[-1], zeros, [len(f2)]])
            best = int((np.diff(edges) - 1).max())
        chain = min(best + 1, nb)
    else:
        chain = 1
    if n:
        chain = max(chain, int(((placed - home) % nb).max()) + 1)

    order2 = np.argsort(placed, kind="stable")
    pb = placed[order2]
    slot = np.arange(n) - np.searchsorted(pb, pb)
    S = slots_per_bucket
    table = np.zeros((nb, S * 4), np.uint32)
    rows = pb
    table[rows, slot] = hi[order2]
    table[rows, S + slot] = lo[order2]
    table[rows, 2 * S + slot] = pos[order2]
    meta = (np.uint32(1) << np.uint32(31)) | flag[order2].astype(np.uint32)
    if info is not None:
        meta = meta | (info[order2].astype(np.uint32) << np.uint32(16))
    table[rows, 3 * S + slot] = meta
    return HostHashTable(table=table, nb=nb, chain=int(chain))


def ht_lookup_both(table2d: torch.Tensor, nb: int, chain: int,
                   q_hi: torch.Tensor, q_lo: torch.Tensor, valid=None):
    """Combined-table lookup over any query shape. ``table2d`` is the
    (nb, 128) int32 table; queries are int64 words. Masked lanes probe
    bucket 0 and read as misses. The first match in each dictionary wins.

    Returns (r_hit, r_pos, r_flag, s_hit, s_pos, s_info, s_flag), the
    words and fields as int64."""
    shp = q_hi.shape
    q_hi = q_hi.reshape(-1)
    q_lo = q_lo.reshape(-1)
    h = hash32(q_lo) ^ ((hash32(q_hi) * _MIX) & M32)
    b = h & (nb - 1)
    if valid is not None:
        valid = valid.reshape(-1)
        b = torch.where(valid, b, 0)
    S = table2d.shape[1] // 4
    qh = as_i32(q_hi)[:, None]
    ql = as_i32(q_lo)[:, None]
    zeros = torch.zeros_like(q_hi)
    r_found = torch.zeros_like(q_hi, dtype=torch.bool)
    s_found = torch.zeros_like(r_found)
    r_pos, s_pos, r_meta, s_meta = zeros, zeros, zeros, zeros
    for c in range(chain):
        row = table2d[(b + c) % nb]
        hi_s = row[:, 0:S]
        lo_s = row[:, S:2 * S]
        pos_s = row[:, 2 * S:3 * S]
        meta = row[:, 3 * S:4 * S]
        keyeq = (meta < 0) & (hi_s == qh) & (lo_s == ql)   # occupied bit 31
        tag_snp = (meta & 0x80) != 0
        for is_snp in (False, True):
            m = keyeq & (tag_snp if is_snp else ~tag_snp)
            anym = m.any(-1)
            sel_pos = torch.where(m, pos_s, 0).sum(-1) & M32
            sel_meta = torch.where(m, meta, 0).sum(-1) & M32
            if is_snp:
                new = anym & ~s_found
                s_pos = torch.where(new, sel_pos, s_pos)
                s_meta = torch.where(new, sel_meta, s_meta)
                s_found = s_found | anym
            else:
                new = anym & ~r_found
                r_pos = torch.where(new, sel_pos, r_pos)
                r_meta = torch.where(new, sel_meta, r_meta)
                r_found = r_found | anym
    if valid is not None:
        r_found = r_found & valid
        s_found = s_found & valid
        r_pos = torch.where(valid, r_pos, 0)
        s_pos = torch.where(valid, s_pos, 0)
        r_meta = torch.where(valid, r_meta, 0)
        s_meta = torch.where(valid, s_meta, 0)
    out = (r_found, r_pos, r_meta & 0x7F, s_found, s_pos,
           (s_meta >> 16) & 0xFF, s_meta & 0x7F)
    return tuple(o.reshape(shp) for o in out)
