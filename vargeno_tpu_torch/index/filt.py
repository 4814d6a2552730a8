"""Port of ``vargeno_tpu/index/filt.py``, no longer a pure copy:
``filt_ref_dict`` is the JAX function as it was (the in-memory filter the
tests hold the streamed one against), and ``filt_prefix`` streams. Its
host memory is one bit a genome base (the near-SNP mask) and a chunk of
rows, not the dictionary's width: the ref columns are read FILT_CHUNK rows
at a time through ``store.read_rows``, the kept rows appended to the
output's ``.npy`` files, and every other array copied in chunks. The
``.vgt/`` it writes is byte-identical to the JAX ``filt_prefix``'s
(tests/test_torch_filt_stream.py).

`filt`: shrink the ref dictionary to SNP-proximal k-mers.

Vectorized reimplementation of dict_filt (src/dict_filt.c:23-79): keep rows
that are ambiguous, POS_AMBIGUOUS, or whose position lies within READ_LEN-1
bases of any SNP location (proximity window [pos-(READ_LEN-32), pos+READ_LEN-1],
src/dict_filt.c:9-21). The aux table is passed through unchanged.
"""

from __future__ import annotations

import io
import os

import numpy as np

from ..config import FLAG_AMBIGUOUS, POS_AMBIGUOUS
from .dictgen import RefDict
from . import store

FILT_CHUNK = 1 << 21     # rows, and genome bases, a chunk of filt_prefix
COPY_BYTES = 1 << 26     # bytes a chunk of an array filt_prefix copies
REF_COLUMNS = ("ref_kmers", "ref_pos", "ref_flag")


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


def near_bits(locs: np.ndarray, read_len: int) -> np.ndarray:
    """Bit p of the result (little-endian bit order) says that a SNP lies
    in [p - (read_len - 32), p + read_len - 1] clipped to the genome
    [0, size), size = ``locs``' length: ``filt_ref_dict``'s window, whose
    clipping is the same as bases outside holding no SNP. Read from
    ``locs`` (a map of the index's file) FILT_CHUNK bases at a time,
    rounded up to whole bytes."""
    size = locs.shape[0]
    before, after = read_len - 32, read_len - 1
    w = before + after + 1
    step = -(-max(FILT_CHUNK, 1) // 8) * 8
    bits = np.empty(-(-size // 8), np.uint8)
    for a in range(0, size, step):
        b = min(a + step, size)
        # ext[i] is base a - before + i; bases outside the genome hold none
        ext = np.zeros(b - a + w - 1, np.uint8)
        s, e = max(a - before, 0), min(b + after, size)
        ext[s - (a - before):e - (a - before)] = store.read_rows(locs, s, e)
        cs = np.zeros(ext.size + 1, np.int32)
        np.cumsum(ext, dtype=np.int32, out=cs[1:])
        near = cs[w:w + b - a] > cs[:b - a]
        bits[a // 8:a // 8 + -(-(b - a) // 8)] = np.packbits(
            near, bitorder="little")
    return bits


def keep_rows(pos: np.ndarray, flag: np.ndarray, bits: np.ndarray,
              size: int) -> np.ndarray:
    """``filt_ref_dict``'s kept rows of a chunk of ref rows, by
    ``near_bits``' mask of a genome of ``size`` bases."""
    q = np.minimum(pos, np.uint32(size - 1))   # pos >= size: masked below
    near = (bits[q >> 3] >> (q & 7).astype(np.uint8)) & 1
    return (pos == POS_AMBIGUOUS) | (flag == FLAG_AMBIGUOUS) | (
        near.view(bool) & (pos < size))


def _npy_header(dtype: np.dtype, shape: tuple) -> bytes:
    """The header ``np.save`` writes for a C-ordered array of ``dtype`` and
    ``shape``."""
    d = np.lib.format.header_data_from_array_1_0(np.empty(0, dtype))
    d["shape"] = shape
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, d)
    return buf.getvalue()


class NpyWriter:
    """A ``.npy`` file written a chunk of rows at a time, byte-identical to
    ``np.save`` of the rows together: its header, for the rows written, is
    put in place when it is closed (numpy pads the header so that its
    length does not depend on the row count; where it does, the rows are
    moved behind the longer header)."""

    def __init__(self, path: str, dtype, row_shape=()):
        self.path, self.dtype = path, np.dtype(dtype)
        self.row_shape, self.rows = tuple(row_shape), 0
        self.f = open(path, "wb")
        self.f.write(_npy_header(self.dtype, (0,) + self.row_shape))
        self.start = self.f.tell()

    def append(self, rows: np.ndarray) -> None:
        np.ascontiguousarray(rows, self.dtype).tofile(self.f)
        self.rows += rows.shape[0]

    def close(self) -> None:
        hdr = _npy_header(self.dtype, (self.rows,) + self.row_shape)
        if len(hdr) == self.start:
            self.f.seek(0)
            self.f.write(hdr)
            self.f.close()
            return
        self.f.close()
        tmp = self.path + ".tmp"
        with open(self.path, "rb") as src, open(tmp, "wb") as dst:
            dst.write(hdr)
            src.seek(self.start)
            while True:
                got = src.read(COPY_BYTES)
                if not got:
                    break
                dst.write(got)
        os.replace(tmp, self.path)


def copy_array(a: np.ndarray, path: str) -> None:
    """``np.save(path, a)`` a chunk of COPY_BYTES at a time
    (``store.read_rows``: a map's rows are read from its file)."""
    w = NpyWriter(path, a.dtype, a.shape[1:])
    step = max(COPY_BYTES // max(a.itemsize * int(np.prod(a.shape[1:])), 1),
               1)
    try:
        for s in range(0, a.shape[0], step):
            w.append(store.read_rows(a, s, s + step))
    finally:
        w.close()


def _source_arrays(prefix: str):
    """(index, its arrays by ``store._DIR_ARRAYS`` key): those of a
    ``.vgt/`` directory each a map of its file (``snp_locations`` too, which
    ``load_dir`` hands out as a plain view of its map)."""
    index = store.load(prefix)
    vals = store.dir_values(index)
    d = prefix + ".vgt"
    if os.path.isdir(d):
        vals["snp_locations"] = np.load(
            os.path.join(d, store._DIR_ARRAYS["snp_locations"] + ".npy"),
            mmap_mode="r")
    return index, vals


def filt_prefix(prefix: str, out_prefix: str, read_len: int = 101) -> int:
    """``filt`` of the index at ``prefix`` into ``<out_prefix>.vgt/``:
    ``filt_ref_dict``'s rows, streamed FILT_CHUNK rows at a time, the kept
    rows written in key order; every other array as it is. Returns the
    kept ref rows."""
    index, vals = _source_arrays(prefix)
    locs = vals["snp_locations"]
    if locs.shape[0] == 0:
        raise SystemExit("index has no snp_locations; rebuild it with the "
                         "index subcommand")
    d = out_prefix + ".vgt"
    src = prefix + ".vgt"
    if os.path.isdir(d) and os.path.isdir(src) \
            and os.path.samefile(d, src):
        raise SystemExit("filt writes a new index: give it another "
                         "out_prefix than the index's own")
    size = locs.shape[0]
    cols = [vals[k] for k in REF_COLUMNS]
    step = max(FILT_CHUNK, 1)

    def path(key):
        return os.path.join(d, store._DIR_ARRAYS[key] + ".npy")

    bits = near_bits(locs, read_len)
    store.begin_dir(d)
    out = [NpyWriter(path(k), c.dtype) for k, c in zip(REF_COLUMNS, cols)]
    try:
        for s in range(0, cols[0].shape[0], step):
            kmers, pos, flag = (store.read_rows(c, s, s + step) for c in cols)
            i = np.flatnonzero(keep_rows(pos, flag, bits, size))
            for w, c in zip(out, (kmers, pos, flag)):
                w.append(c.take(i))
    finally:   # meta.json is not written: no index on a failure
        for w in out:
            w.close()
    del bits
    for key in store._DIR_ARRAYS:
        if key not in REF_COLUMNS:
            copy_array(vals[key], path(key))
    store.write_meta(d, index)
    kept = out[0].rows
    print(f"New size: {kept}")
    return kept
