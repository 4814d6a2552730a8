"""Jax-free copy of ``vargeno_tpu/index/filt.py``.

`filt`: shrink the ref dictionary to SNP-proximal k-mers.

Vectorized reimplementation of dict_filt (src/dict_filt.c:23-79): keep rows
that are ambiguous, POS_AMBIGUOUS, or whose position lies within READ_LEN-1
bases of any SNP location (proximity window [pos-(READ_LEN-32), pos+READ_LEN-1],
src/dict_filt.c:9-21). The aux table is passed through unchanged.
"""

from __future__ import annotations

import numpy as np

from ..config import FLAG_AMBIGUOUS, POS_AMBIGUOUS
from .dictgen import RefDict
from . import store


def filt_ref_dict(ref: RefDict, snp_locations: np.ndarray,
                  read_len: int = 101) -> RefDict:
    locs = np.asarray(snp_locations, bool)
    size = locs.shape[0]
    # windowed any-SNP test via prefix sums
    cs = np.concatenate([[0], np.cumsum(locs.astype(np.int64))])

    pos = ref.pos.astype(np.int64)
    lo = np.where(pos > (read_len - 32), pos - (read_len - 32), 0)
    hi = np.where(pos < size - (read_len - 1), pos + (read_len - 1), size - 1)
    lo_c = np.clip(lo, 0, size)
    hi_c = np.clip(hi + 1, 0, size)
    near = (cs[hi_c] - cs[lo_c]) > 0
    near = near & (pos < size)  # pos >= size -> false (dict_filt.c:11-12)

    keep = (ref.pos == POS_AMBIGUOUS) | (ref.flag == FLAG_AMBIGUOUS) | near
    return RefDict(kmers=ref.kmers[keep], pos=ref.pos[keep],
                   flag=ref.flag[keep], aux=ref.aux)


def filt_prefix(prefix: str, out_prefix: str,
                read_len: int = 101) -> None:
    index = store.load(prefix)
    if index.snp_locations is None:
        raise SystemExit("index has no snp_locations; rebuild it with the "
                         "index subcommand")
    new_ref = filt_ref_dict(index.ref, index.snp_locations, read_len)
    index.ref = new_ref
    store.save(out_prefix, index)
    print(f"New size: {new_ref.kmers.shape[0]}")
