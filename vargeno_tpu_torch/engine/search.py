"""Batched lower bound over sorted (hi, lo) 32-bit key pairs (port of
``vargeno_tpu/engine/search.py`` ``lower_bound``, the one function the
sharded-dictionary backend calls there).

The JAX loop runs ~ceil(log2 n) + 1 rounds of gathers and compares; eager
PyTorch would pay ~10 launches a round. Here a dictionary carries one
order-preserving int64 key a row, and a search is one ``torch.searchsorted``:

    okey(hi, lo) = (hi - 2**31) * 2**32 + lo

is the unsigned 64-bit key ``hi << 32 | lo`` with its top bit flipped, read
as a signed int64, so signed order is (hi, lo) order and the pad row
(0xFFFFFFFF, 0xFFFFFFFF) maps to the largest int64 and sorts last. The
arithmetic form cannot overflow for words in [0, 2**32). Queries are int64
32-bit words (the step's convention); tables keep their words as int32 bit
patterns elsewhere in the port, so callers widen before they build keys.

``lower_bound_loop`` is the JAX loop itself, kept as the plain twin that
the tests hold the searchsorted form against.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.hashes import M32

_TOP = 1 << 31


def okey(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key of int64 32-bit word pairs."""
    return (hi - _TOP) * (1 << 32) + lo


def np_okey(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host form of ``okey`` over uint32 arrays."""
    k = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (k ^ np.uint64(1 << 63)).view(np.int64)


def key_hi(keys: torch.Tensor) -> torch.Tensor:
    """The hi 32-bit words of ``okey`` keys."""
    return (keys >> 32) + _TOP


def key_lo(keys: torch.Tensor) -> torch.Tensor:
    """The lo 32-bit words of ``okey`` keys."""
    return keys & M32


def lower_bound(keys: torch.Tensor, q_hi: torch.Tensor,
                q_lo: torch.Tensor) -> torch.Tensor:
    """Leftmost i with keys[i] >= (q_hi, q_lo); n if none. ``keys`` (n,)
    sorted ``okey`` int64; queries int64 words of any shape. int64 result of
    the query shape. (The JAX loop returns n + 1 instead of n when every key
    is below the query and its halving reaches lo = hi = n before its last
    round; every caller clamps the result to a row count <= n first.)"""
    return torch.searchsorted(keys, okey(q_hi, q_lo))


def block_end(keys: torch.Tensor, q_hi: torch.Tensor) -> torch.Tensor:
    """Leftmost i whose hi word exceeds q_hi: the JAX package's
    ``lower_bound(keys, q_hi + 1, 0)`` without its uint32 wrap at q_hi =
    0xFFFFFFFF, where both callers replace the result anyway."""
    return torch.searchsorted(keys, okey(q_hi, torch.full_like(q_hi, M32)),
                              side="right")


def lower_bound_loop(keys_hi: torch.Tensor, keys_lo: torch.Tensor,
                     q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """The JAX loop: ~ceil(log2 n) + 1 rounds of gather + compare over
    (n,) int64 word columns sorted by (hi, lo), with JAX's clamped gather
    (so it returns n + 1 where the JAX loop does)."""
    n = keys_hi.shape[0]
    lo = torch.zeros(q_hi.shape, dtype=torch.int64, device=q_hi.device)
    if n == 0:
        return lo
    hi = torch.full(q_hi.shape, n, dtype=torch.int64, device=q_hi.device)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))) + 1)):
        mid = (lo + hi) >> 1
        mc = mid.clamp(max=n - 1)   # JAX clamps the gather at mid = n
        khi = keys_hi[mc]
        klo = keys_lo[mc]
        less = (khi < q_hi) | ((khi == q_hi) & (klo < q_lo))
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return lo
