"""Jax-free copy of the host functions of ``vargeno_tpu/core/kmer.py``, plus
torch versions of the device batch encode and reverse complement
(``vargeno_tpu/engine/batch.py`` encode_batch, _bitrev2_u32, rc_enc).

Bit layout matches the reference exactly: base at *string index* ``i`` of the
32-mer occupies bits ``[2i, 2i+1]`` of the packed 64-bit word (reference:
src/util.c:89-111). On the device a k-mer is a pair of 32-bit words: ``lo``
holds string bases 0..15, ``hi`` bases 16..31. In the torch engine every such
word is an int64 tensor holding the unsigned value in [0, 2**32) (torch has no
shifts or ordering on uint32).

Base codes: A=0 C=1 G=2 T=3 N=4 (src/vartype.h:20-24).
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

# --- host-side numpy mirrors (used by index build and the oracle) ---

_NP_BASE = np.full(256, 7, dtype=np.uint8)  # BASE_X
for ch, code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("N", 4)):
    _NP_BASE[ord(ch)] = code
    _NP_BASE[ord(ch.lower())] = code


def np_codes_from_bytes(seq_bytes: bytes) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (A0 C1 G2 T3 N4, other 7)."""
    arr = np.frombuffer(seq_bytes, dtype=np.uint8)
    return _NP_BASE[arr]


def np_pack_kmers_u64(codes: np.ndarray) -> np.ndarray:
    """(..., 32) codes -> packed uint64 k-mers (host)."""
    c = codes.astype(np.uint64)
    shifts = (np.arange(32, dtype=np.uint64) * np.uint64(2))
    return np.sum(c << shifts, axis=-1, dtype=np.uint64)


def np_rolling_kmers_u64(codes: np.ndarray) -> np.ndarray:
    """All overlapping 32-mers of a 1-D code array as uint64, vectorized.

    Equivalent to the rolling shift_kmer walk (reference: src/dictgen.c:26-47)
    but computed as 32 shifted adds. Caller masks out windows containing N.
    """
    n = codes.shape[0] - 32 + 1
    if n <= 0:
        return np.zeros((0,), dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    c = codes.astype(np.uint64)
    for j in range(32):
        out |= (c[j : j + n] & np.uint64(3)) << np.uint64(2 * j)
    return out


def np_window_has_n(codes: np.ndarray, k: int = 32) -> np.ndarray:
    """Boolean mask over windows: True if any of the k bases is not in 0..3."""
    bad = (codes > 3).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    return (cs[k:] - cs[:-k]) > 0


def np_revcomp_u64(kmers: np.ndarray) -> np.ndarray:
    """Reverse complement of packed uint64 k-mers (host mirror of
    src/util.c:139-180 rev_compl)."""
    x = kmers.astype(np.uint64)
    out = np.zeros_like(x)
    for i in range(32):
        base = (x >> np.uint64(2 * i)) & np.uint64(3)
        out |= (np.uint64(3) - base) << np.uint64(2 * (31 - i))
    return out


def np_encode_batch(codes: np.ndarray, n_kmers: np.ndarray, K: int):
    """numpy mirror of the device batch encode (engine/batch.py
    encode_batch; reference read-encoding semantics src/qv.cc:810-828).

    Returns (hi, lo) (B, K) uint32, kmer_valid (B, K) bool, read_ok (B,)
    bool. Fallback for native.encode_batch."""
    B = codes.shape[0]
    win = codes[:, : K * 32].reshape(B, K, 32).astype(np.uint32)
    good = win <= 3
    shifts = (np.arange(16, dtype=np.uint32) * 2)
    lo = np.sum(np.where(good[..., :16], win[..., :16], 0) << shifts,
                axis=-1, dtype=np.uint64).astype(np.uint32)
    hi = np.sum(np.where(good[..., 16:], win[..., 16:], 0) << shifts,
                axis=-1, dtype=np.uint64).astype(np.uint32)
    slot = np.arange(K)[None, :]
    in_read = slot < np.minimum(n_kmers, K)[:, None]
    win_bad = ~good.all(axis=-1)
    read_ok = ~(win_bad & in_read).any(axis=-1)
    kmer_valid = in_read & read_ok[:, None]
    return hi, lo, kmer_valid, read_ok


# --- torch device versions ---

def encode_batch(codes: torch.Tensor, n_kmers: torch.Tensor, K: int):
    """codes (B, L) uint8 -> kmer (hi, lo) (B, K) int64 words + validity.

    A read whose first n_kmers*32 bases contain any non-ACGT code is dropped
    entirely (src/qv.cc:812-828: N aborts the orientation AND the read)."""
    B = codes.shape[0]
    win = codes[:, : K * 32].reshape(B, K, 32).long()
    good = win <= 3
    shifts = torch.arange(16, device=codes.device) * 2
    c = torch.where(good, win, 0)
    lo = (c[..., :16] << shifts).sum(-1)
    hi = (c[..., 16:] << shifts).sum(-1)
    slot = torch.arange(K, device=codes.device)[None, :]
    in_read = slot < n_kmers.long()[:, None]
    win_bad = ~good.all(-1)
    read_ok = ~(win_bad & in_read).any(-1)
    kmer_valid = in_read & read_ok[:, None]
    return hi, lo, kmer_valid, read_ok


def bitrev2_u32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit fields of 32-bit words held in int64."""
    m2, m4, m8 = 0x33333333, 0x0F0F0F0F, 0x00FF00FF
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return ((x << 16) | (x >> 16)) & M32


def rc_enc(hi, lo, kmer_valid, read_ok, n_kmers, K: int):
    """Reverse-complement orientation of an encoded batch, derived from the
    packed kmer words alone (src/qv.cc:787-806; with 32-aligned truncation,
    RC kmer j is the base-reversed complement of forward kmer nk-1-j).
    Validity masks are symmetric under RC, so they carry over unchanged."""
    rhi = bitrev2_u32(lo ^ M32)
    rlo = bitrev2_u32(hi ^ M32)
    j = torch.arange(K, device=hi.device)[None, :]
    src = (n_kmers.long()[:, None] - 1 - j).clamp(0, K - 1)
    return (torch.gather(rhi, 1, src), torch.gather(rlo, 1, src),
            kmer_valid, read_ok)
