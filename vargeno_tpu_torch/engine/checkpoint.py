"""Jax-free copy of ``vargeno_tpu/engine/checkpoint.py``; the file pair
(``<path>.npz`` + ``<path>.json``) is the same, so a checkpoint written by
either package is read by the other.

Batch-level checkpoint/resume of a genotyping stream.

The reference has no mid-run checkpointing (SURVEY.md §5); a crash loses the
whole run. Here the persistent state is tiny and exact: the per-site pileup
count tensor plus the read offset -- counts are order-independent saturating
sums, so resuming from the last checkpointed batch boundary reproduces the
exact same output as an uninterrupted run.
"""

from __future__ import annotations

import json
import os

import numpy as np


def save(path: str, ref_cnt, alt_cnt, n_reads: int, extra: dict | None = None
         ) -> None:
    tmp = path + ".tmp"
    np.savez_compressed(tmp + ".npz",
                        ref_cnt=np.asarray(ref_cnt),
                        alt_cnt=np.asarray(alt_cnt))
    os.replace(tmp + ".npz", path + ".npz")
    meta = {"n_reads": int(n_reads)}
    if extra:
        meta.update(extra)
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path + ".json")


def load(path: str):
    """Returns (ref_cnt, alt_cnt, meta) or None if no checkpoint exists.

    A PRESENT-but-unreadable checkpoint raises (silently restarting from
    zero would double-count every read before the corruption)."""
    if not (os.path.exists(path + ".npz") and os.path.exists(path + ".json")):
        return None
    try:
        z = np.load(path + ".npz")
        with open(path + ".json") as f:
            meta = json.load(f)
        return z["ref_cnt"], z["alt_cnt"], meta
    except Exception as e:  # noqa: BLE001 - any unreadable container
        from ..errors import InputError

        raise InputError(
            f"{path}.npz/.json: checkpoint exists but is unreadable "
            f"({e}); delete both files to restart from the beginning, or "
            f"restore them from a copy") from e
