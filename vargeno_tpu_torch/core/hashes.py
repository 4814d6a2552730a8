"""Bloom-filter hashes and 32-bit word helpers: numpy host forms (jax-free
copies of ``vargeno_tpu/core/hashes.py`` np_hash32/np_hash40) and torch
device forms.

The reference uses two hashes (src/generate_bf.h:125-142):

- ``hash32``: the 32-bit avalanche (x>>16 ^ x) * 0x45d9f3b, twice, applied to
  the LOW 32 bits of a ref k-mer.
- ``hash40``: the splitmix64 finalizer applied to the LOW 40 bits of a SNP
  k-mer, reduced modulo the SNP filter's 1.12e9 bits.

The torch forms take the place of the JAX package's 32-bit limb arithmetic
(``vargeno_tpu/core/u64.py``): a 32-bit word is an int64 tensor holding the
unsigned value in [0, 2**32), and a 64-bit hash is an int64 tensor holding
the unsigned bit pattern. int64 multiplication wraps mod 2**64, and since
``>>`` on int64 is arithmetic, every right shift of a 64-bit pattern is
masked to the bits a logical shift would keep.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (the device tables) -> int64 32-bit words."""
    return t.long() & M32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 32-bit words -> the int32 bit patterns."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _shr64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of a 64-bit pattern held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def hash32(x: torch.Tensor) -> torch.Tensor:
    """hash32 over 32-bit words held in int64 (mod 2**32 wraparound)."""
    m = 0x45D9F3B
    x = (((x >> 16) ^ x) * m) & M32
    x = (((x >> 16) ^ x) * m) & M32
    return (x >> 16) ^ x


def hash40(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over non-negative int64 values; returns the
    64-bit result's bit pattern as int64."""
    x = (x ^ _shr64(x, 30)) * _i64(_C1)
    x = (x ^ _shr64(x, 27)) * _i64(_C2)
    return x ^ _shr64(x, 31)


def mod_const(h: torch.Tensor, m: int) -> torch.Tensor:
    """Exact ``h mod m`` of a 64-bit pattern held in int64, for a static
    1 < m < 2**31: split into 32-bit halves, ((hi % m) << 32 | lo) % m. The
    middle value stays below 2**63, so the int64 remainders are exact."""
    if not 1 < m < (1 << 31):
        raise ValueError(f"mod_const: modulus {m} outside (1, 2**31)")
    if m & (m - 1) == 0:
        return h & (m - 1)
    hi = _shr64(h, 32)
    lo = h & M32
    return (((hi % m) << 32) | lo) % m


def snp_bf_bit(hi8: torch.Tensor, lo: torch.Tensor, snp_bf_bits: int):
    """Bit index into the SNP Bloom filter for a lo40 value given as a word
    pair; ``hi8`` must already be masked to its low 8 bits."""
    return mod_const(hash40((hi8 << 32) | lo), snp_bf_bits)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of 32-bit words held in int64 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def ctz32(x: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of 32-bit words held in int64; 32 for zero."""
    return torch.where(x == 0, 32, popcount((x & -x) - 1))


# --- host numpy mirrors ---

def np_hash32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        m = np.uint32(0x45D9F3B)
        x = ((x >> np.uint32(16)) ^ x) * m
        x = ((x >> np.uint32(16)) ^ x) * m
        return (x >> np.uint32(16)) ^ x


def np_hash40(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(_C1)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(_C2)
        x = x ^ (x >> np.uint64(31))
    return x
