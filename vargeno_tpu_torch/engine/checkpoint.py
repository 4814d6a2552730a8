"""Jax-free port of ``vargeno_tpu/engine/checkpoint.py``, with a checkpoint
that cannot tear: the meta dict (``n_reads`` and any extra keys) is saved
inside ``<path>.npz`` beside the counts, as one JSON string entry
(``meta``, a plain unicode array that ``np.load`` reads without pickle), so
that the single ``os.replace`` of the npz commits counts and read offset
together. ``<path>.json`` is still written after it, for the JAX package's
``load``, which reads the offset only from there; this ``load`` takes the
meta from the npz when the entry is there and falls back to the JSON for a
checkpoint the JAX package wrote. Either package reads the other's files.

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

META = "meta"   # the npz entry holding the meta dict as a JSON string


def save(path: str, ref_cnt, alt_cnt, n_reads: int, extra: dict | None = None
         ) -> None:
    tmp = path + ".tmp"
    meta = {"n_reads": int(n_reads)}
    if extra:
        meta.update(extra)
    text = json.dumps(meta)
    np.savez_compressed(tmp + ".npz",
                        ref_cnt=np.asarray(ref_cnt),
                        alt_cnt=np.asarray(alt_cnt),
                        **{META: np.array(text)})
    os.replace(tmp + ".npz", path + ".npz")   # the commit point
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path + ".json")


def _meta_of(z, path: str):
    """The meta dict of the opened npz ``z``: its own entry, else (a
    checkpoint of the JAX package) ``<path>.json``; None when neither is
    there (the JAX package's first save, torn before its JSON)."""
    if META in z.files:
        return json.loads(str(z[META]))
    if not os.path.exists(path + ".json"):
        return None
    with open(path + ".json") as f:
        return json.load(f)


def _read(path: str, counts: bool):
    if not os.path.exists(path + ".npz"):
        return None
    try:
        with np.load(path + ".npz") as z:
            meta = _meta_of(z, path)
            if meta is None or not counts:
                return meta
            return z["ref_cnt"], z["alt_cnt"], meta
    except Exception as e:  # noqa: BLE001 - any unreadable container
        from ..errors import InputError

        raise InputError(
            f"{path}.npz/.json: checkpoint exists but is unreadable "
            f"({e}); delete both files to restart from the beginning, or "
            f"restore them from a copy") from e


def load(path: str):
    """Returns (ref_cnt, alt_cnt, meta) or None if no checkpoint exists.

    A PRESENT-but-unreadable checkpoint raises (silently restarting from
    zero would double-count every read before the corruption)."""
    return _read(path, counts=True)


def read_meta(path: str):
    """The meta dict of the checkpoint at ``path`` without its counts (the
    npz's own entry is read alone), or None if no checkpoint exists."""
    return _read(path, counts=False)
