"""Jax-free port of ``vargeno_tpu/index/store.py``, no longer a pure copy:
``save_dir`` also drops the port's own derived-table cache
(``derived_torch/``) and the meta.json of a prior index, and is split into
``begin_dir``, ``dir_values`` and ``write_meta``, which the streamed
``filt`` shares; ``exists`` needs the directory's meta.json (written
last), ``load_dir`` keeps ``snp_locations`` mapped, and ``read_rows``
reads a chunk of a memory-mapped column from its file. The arrays it
writes must equal the JAX ``build_index``'s
(tests/test_torch_wgs_stream.py).

Index persistence and interop with the reference's on-disk formats.

Native format: a single ``<prefix>.vgt.npz`` holding every array (compressed),
plus ``<prefix>.chrlens`` for CLI parity.

Interop: readers/writers for the reference's little-endian binary formats so
indexes can be cross-validated against (or consumed from) the original tool:
- ``.ref.dict``: u64 n_rows, u64 n_aux; n x (u64 kmer, u32 pos, u8 flag);
  n_aux x (10 x u32)                      (src/dictgen.c:63-148, qv.cc:520-590)
- ``.snp.dict``: u64 n, u64 m; n x (u64, u32 pos, u8 snp, u8 flag, u8 rf,
  u8 af); m x (u64 kmer, 10 x (u32 pos, u8 snp, u8 rf, u8 af))
                                          (src/dictgen.c:156-269, qv.cc:606-695)
- ``.bf``: sdsl bit_vector serialization: u64 bit-count then
  ceil(bits/64) LSB-first u64 words       (sdsl int_vector::serialize)
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..config import POS_AMBIGUOUS, FLAG_UNAMBIGUOUS
from .bloom import BitVector
from .dictgen import RefDict, SnpDict

_REF_ROW = np.dtype([("kmer", "<u8"), ("pos", "<u4"), ("flag", "u1")])
_SNP_ROW = np.dtype([("kmer", "<u8"), ("pos", "<u4"), ("snp", "u1"),
                     ("flag", "u1"), ("rf", "u1"), ("af", "u1")])
_SNP_AUX_COL = np.dtype([("pos", "<u4"), ("snp", "u1"), ("rf", "u1"),
                         ("af", "u1")])
_SNP_AUX_ROW = np.dtype([("kmer", "<u8"), ("cols", _SNP_AUX_COL, (10,))])


@dataclasses.dataclass
class SnpSites:
    """The seeded pileup entries, i.e. the callable SNP sites.

    Derived from unambiguous SNP-dict rows exactly as the reference seeds its
    pileup table at load time (src/qv.cc:637-660), including later rows
    overwriting earlier ones at the same position. Sorted by position.
    """

    pos: np.ndarray   # (s,) uint32, sorted ascending, unique
    ref: np.ndarray   # (s,) uint8 base code
    alt: np.ndarray   # (s,) uint8 base code
    rf: np.ndarray    # (s,) uint8 encoded freq
    af: np.ndarray    # (s,) uint8


@dataclasses.dataclass
class VarGenoIndex:
    ref: RefDict
    snp: SnpDict
    ref_bf: BitVector
    snp_bf: BitVector
    chrlens: List[Tuple[str, int]]
    sites: SnpSites
    snp_locations: np.ndarray | None = None  # bool array for `filt`
    # set by load()/load_dir(): lets the engine cache derived device
    # tables (hash tables, prefilters) next to the index on disk
    prefix: str | None = None


def derive_sites(snp: SnpDict) -> SnpSites:
    """Replicate the pileup-seeding loop (src/qv.cc:637-660) vectorized."""
    snp_off = (snp.snp >> 3) & 0x1F
    snp_ref = snp.snp & 0x07
    sel = ((snp_ref & 4) == 0) & (snp.pos != POS_AMBIGUOUS) & (
        snp.flag == FLAG_UNAMBIGUOUS)
    idx = np.flatnonzero(sel)
    pos = (snp.pos[idx] + snp_off[idx]).astype(np.uint32)
    alt = ((snp.kmers[idx] >> (np.uint64(2) * snp_off[idx].astype(np.uint64)))
           & np.uint64(3)).astype(np.uint8)
    ref = snp_ref[idx].astype(np.uint8)
    rf = snp.ref_freq[idx]
    af = snp.alt_freq[idx]
    # later rows overwrite earlier rows at the same position
    order = np.argsort(pos, kind="stable")
    pos_s = pos[order]
    uniq, last_of_run = np.unique(pos_s[::-1], return_index=True)
    take = order[::-1][last_of_run]  # last (highest dict row) writer wins
    return SnpSites(pos=uniq.astype(np.uint32), ref=ref[take], alt=alt[take],
                    rf=rf[take], af=af[take])


# --- native npz format ---

def save_npz(prefix: str, index: VarGenoIndex) -> None:
    names = np.array([n for n, _ in index.chrlens])
    lens = np.array([l for _, l in index.chrlens], np.uint64)
    # uncompressed: the Bloom words are high-entropy (zlib wins little) and
    # geno startup reads this file every run -- decompression cost (~25 s at
    # chr22 scale) dwarfs the disk-size win. np.load reads either form.
    np.savez(
        prefix + ".vgt.npz",
        ref_kmers=index.ref.kmers, ref_pos=index.ref.pos,
        ref_flag=index.ref.flag, ref_aux=index.ref.aux,
        snp_kmers=index.snp.kmers, snp_pos=index.snp.pos,
        snp_snp=index.snp.snp, snp_flag=index.snp.flag,
        snp_rf=index.snp.ref_freq, snp_af=index.snp.alt_freq,
        snp_aux_kmer=index.snp.aux_kmer, snp_aux_pos=index.snp.aux_pos,
        snp_aux_snp=index.snp.aux_snp, snp_aux_rf=index.snp.aux_rf,
        snp_aux_af=index.snp.aux_af,
        ref_bf_bits=np.uint64(index.ref_bf.bits),
        ref_bf_words=index.ref_bf.words,
        snp_bf_bits=np.uint64(index.snp_bf.bits),
        snp_bf_words=index.snp_bf.words,
        chr_names=names, chr_lens=lens,
        snp_locations=(index.snp_locations
                       if index.snp_locations is not None
                       else np.zeros(0, bool)),
        # derived sites persisted so geno startup skips the (multi-second)
        # derive_sites pass; older files without them still load
        site_pos=index.sites.pos, site_ref=index.sites.ref,
        site_alt=index.sites.alt, site_rf=index.sites.rf,
        site_af=index.sites.af,
    )


def _format_err(path, what, cause=None):
    from ..errors import IndexFormatError

    raise IndexFormatError(
        f"{path}: {what} -- not a vargeno index file, a different format "
        f"version, or truncated; rebuild with `vargeno-tpu index`"
    ) from cause


def load_npz(prefix: str) -> VarGenoIndex:
    path = prefix + ".vgt.npz"
    try:
        z = np.load(path, allow_pickle=False)
    except FileNotFoundError:
        raise
    except Exception as e:  # noqa: BLE001 - any unreadable container
        _format_err(path, f"unreadable archive ({e})", e)
    try:
        return _load_npz_arrays(prefix, z)
    except KeyError as e:
        _format_err(path, f"missing index array {e}", e)


def _load_npz_arrays(prefix: str, z) -> VarGenoIndex:
    ref = RefDict(kmers=z["ref_kmers"], pos=z["ref_pos"], flag=z["ref_flag"],
                  aux=z["ref_aux"])
    snp = SnpDict(kmers=z["snp_kmers"], pos=z["snp_pos"], snp=z["snp_snp"],
                  flag=z["snp_flag"], ref_freq=z["snp_rf"],
                  alt_freq=z["snp_af"], aux_kmer=z["snp_aux_kmer"],
                  aux_pos=z["snp_aux_pos"], aux_snp=z["snp_aux_snp"],
                  aux_rf=z["snp_aux_rf"], aux_af=z["snp_aux_af"])
    chrlens = [(str(n), int(l)) for n, l in zip(z["chr_names"], z["chr_lens"])]
    if "site_pos" in z.files:
        sites = SnpSites(pos=z["site_pos"], ref=z["site_ref"],
                         alt=z["site_alt"], rf=z["site_rf"],
                         af=z["site_af"])
    else:  # pre-0.1 files: derive at load
        sites = derive_sites(snp)
    idx = VarGenoIndex(
        ref=ref, snp=snp,
        ref_bf=BitVector(int(z["ref_bf_bits"]), z["ref_bf_words"]),
        snp_bf=BitVector(int(z["snp_bf_bits"]), z["snp_bf_words"]),
        chrlens=chrlens, sites=sites,
        snp_locations=z["snp_locations"].astype(bool)
        if z["snp_locations"].size else None)
    return idx


# --- native directory format (raw .npy per array, mmap-able) ---

_DIR_ARRAYS = dict(
    ref_kmers="ref.kmers", ref_pos="ref.pos", ref_flag="ref.flag",
    ref_aux="ref.aux", snp_kmers="snp.kmers", snp_pos="snp.pos",
    snp_snp="snp.snp", snp_flag="snp.flag", snp_rf="snp.rf",
    snp_af="snp.af", snp_aux_kmer="snp.aux_kmer", snp_aux_pos="snp.aux_pos",
    snp_aux_snp="snp.aux_snp", snp_aux_rf="snp.aux_rf",
    snp_aux_af="snp.aux_af", ref_bf_words="ref_bf.words",
    snp_bf_words="snp_bf.words", snp_locations="snp_locations",
    site_pos="site.pos", site_ref="site.ref", site_alt="site.alt",
    site_rf="site.rf", site_af="site.af",
)


def dir_values(index: VarGenoIndex) -> dict:
    """The arrays ``save_dir`` writes, by ``_DIR_ARRAYS`` key."""
    return dict(
        ref_kmers=index.ref.kmers, ref_pos=index.ref.pos,
        ref_flag=index.ref.flag, ref_aux=index.ref.aux,
        snp_kmers=index.snp.kmers, snp_pos=index.snp.pos,
        snp_snp=index.snp.snp, snp_flag=index.snp.flag,
        snp_rf=index.snp.ref_freq, snp_af=index.snp.alt_freq,
        snp_aux_kmer=index.snp.aux_kmer, snp_aux_pos=index.snp.aux_pos,
        snp_aux_snp=index.snp.aux_snp, snp_aux_rf=index.snp.aux_rf,
        snp_aux_af=index.snp.aux_af,
        ref_bf_words=index.ref_bf.words, snp_bf_words=index.snp_bf.words,
        snp_locations=(index.snp_locations
                       if index.snp_locations is not None
                       else np.zeros(0, bool)),
        site_pos=index.sites.pos, site_ref=index.sites.ref,
        site_alt=index.sites.alt, site_rf=index.sites.rf,
        site_af=index.sites.af,
    )


def begin_dir(d: str) -> None:
    """Make the index directory ``d`` ready for its arrays: a table cache
    of a prior index there is removed, and so is its meta.json, so that
    the directory counts as an index (``exists``) only once the new
    meta.json is written, last."""
    import os
    import shutil

    os.makedirs(d, exist_ok=True)
    for sub in ("derived", "derived_torch"):
        derived = os.path.join(d, sub)
        if os.path.isdir(derived):  # stale table cache of a prior index
            shutil.rmtree(derived)
    meta = os.path.join(d, "meta.json")
    if os.path.exists(meta):
        os.remove(meta)


def write_meta(d: str, index: VarGenoIndex) -> None:
    """The index directory ``d``'s meta.json, written last."""
    import json
    import os

    meta = dict(version=1,
                ref_bf_bits=int(index.ref_bf.bits),
                snp_bf_bits=int(index.snp_bf.bits),
                chrlens=[[n, int(l)] for n, l in index.chrlens])
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)


def save_dir(prefix: str, index: VarGenoIndex) -> None:
    """``<prefix>.vgt/``: one raw .npy per array + meta.json.

    Unlike the single-zip .vgt.npz, raw .npy files load with
    ``np.load(mmap_mode='r')`` in ~0 time -- the OS pages data in on first
    touch, so geno startup skips the ~15 s zip extraction entirely."""
    import os

    d = prefix + ".vgt"
    begin_dir(d)
    vals = dir_values(index)
    for key, fname in _DIR_ARRAYS.items():
        np.save(os.path.join(d, fname + ".npy"), vals[key])
    write_meta(d, index)


def load_dir(prefix: str, mmap: bool = True) -> VarGenoIndex:
    import json
    import os

    d = prefix + ".vgt"
    try:
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        _format_err(os.path.join(d, "meta.json"),
                    f"unreadable index metadata ({e})", e)
    mm = "r" if mmap else None

    def ld(key):
        p = os.path.join(d, _DIR_ARRAYS[key] + ".npy")
        try:
            return np.load(p, mmap_mode=mm)
        except (OSError, ValueError) as e:
            _format_err(p, f"unreadable index array ({e})", e)

    ref = RefDict(kmers=ld("ref_kmers"), pos=ld("ref_pos"),
                  flag=ld("ref_flag"), aux=ld("ref_aux"))
    snp = SnpDict(kmers=ld("snp_kmers"), pos=ld("snp_pos"),
                  snp=ld("snp_snp"), flag=ld("snp_flag"),
                  ref_freq=ld("snp_rf"), alt_freq=ld("snp_af"),
                  aux_kmer=ld("snp_aux_kmer"), aux_pos=ld("snp_aux_pos"),
                  aux_snp=ld("snp_aux_snp"), aux_rf=ld("snp_aux_rf"),
                  aux_af=ld("snp_aux_af"))
    sites = SnpSites(pos=ld("site_pos"), ref=ld("site_ref"),
                     alt=ld("site_alt"), rf=ld("site_rf"), af=ld("site_af"))
    locs = ld("snp_locations")
    return VarGenoIndex(
        ref=ref, snp=snp,
        ref_bf=BitVector(meta["ref_bf_bits"], ld("ref_bf_words")),
        snp_bf=BitVector(meta["snp_bf_bits"], ld("snp_bf_words")),
        chrlens=[(str(n), int(l)) for n, l in meta["chrlens"]],
        sites=sites,
        # a view of the map (bool on disk): a copy would read the whole
        # genome-length file at every load
        snp_locations=np.asarray(locs, bool) if locs.size else None,
        prefix=prefix)


def read_rows(a: np.ndarray, s: int, e: int) -> np.ndarray:
    """Rows ``s:e`` of an index array as an array of their own. A memory
    map of a whole ``.npy`` file is read from the file, so that streaming a
    genome-scale column through memory leaves none of its pages mapped into
    the process."""
    import mmap

    e = min(e, a.shape[0])
    if not (isinstance(a, np.memmap) and isinstance(a.base, mmap.mmap)
            and a.flags.c_contiguous):
        return np.asarray(a[s:e])
    row = a.strides[0] if a.ndim else a.itemsize
    out = np.fromfile(a.filename, a.dtype, count=max(e - s, 0) * row
                      // a.itemsize, offset=a.offset + s * row)
    return out.reshape((max(e - s, 0),) + a.shape[1:])


def exists(prefix: str) -> bool:
    """A whole native index is there: ``save_dir`` writes its meta.json
    last, so a directory that a stopped build left half-written (or an
    empty one made for the index) does not count."""
    import os

    return (os.path.isfile(os.path.join(prefix + ".vgt", "meta.json"))
            or os.path.exists(prefix + ".vgt.npz"))


def save(prefix: str, index: VarGenoIndex) -> None:
    save_dir(prefix, index)


def load(prefix: str) -> VarGenoIndex:
    """Load a native index: ``<prefix>.vgt/`` (mmap) or ``<prefix>.vgt.npz``."""
    import os

    if os.path.isdir(prefix + ".vgt"):
        return load_dir(prefix)
    return load_npz(prefix)


# --- reference binary formats ---

def write_ref_dict(path: str, d: RefDict) -> None:
    rows = np.zeros(d.kmers.shape[0], _REF_ROW)
    rows["kmer"] = d.kmers
    rows["pos"] = d.pos
    rows["flag"] = d.flag
    with open(path, "wb") as f:
        np.array([rows.shape[0], d.aux.shape[0]], "<u8").tofile(f)
        rows.tofile(f)
        d.aux.astype("<u4").tofile(f)


def read_ref_dict(path: str) -> RefDict:
    with open(path, "rb") as f:
        hdr = np.fromfile(f, "<u8", 2)
        if hdr.size != 2:
            _format_err(path, "missing 16-byte dictionary header")
        n, m = hdr
        rows = np.fromfile(f, _REF_ROW, int(n))
        if rows.size != int(n):
            _format_err(path, f"header promises {n} dict rows, file holds "
                              f"{rows.size}")
        aux = np.fromfile(f, "<u4", int(m) * 10)
        if aux.size != int(m) * 10:
            _format_err(path, f"header promises {m} aux rows, file holds "
                              f"{aux.size // 10}")
        aux = aux.reshape(int(m), 10)
    return RefDict(kmers=rows["kmer"].copy(), pos=rows["pos"].copy(),
                   flag=rows["flag"].copy(), aux=aux)


def write_snp_dict(path: str, d: SnpDict) -> None:
    rows = np.zeros(d.kmers.shape[0], _SNP_ROW)
    rows["kmer"] = d.kmers
    rows["pos"] = d.pos
    rows["snp"] = d.snp
    rows["flag"] = d.flag
    rows["rf"] = d.ref_freq
    rows["af"] = d.alt_freq
    aux = np.zeros(d.aux_kmer.shape[0], _SNP_AUX_ROW)
    aux["kmer"] = d.aux_kmer
    aux["cols"]["pos"] = d.aux_pos
    aux["cols"]["snp"] = d.aux_snp
    aux["cols"]["rf"] = d.aux_rf
    aux["cols"]["af"] = d.aux_af
    with open(path, "wb") as f:
        np.array([rows.shape[0], aux.shape[0]], "<u8").tofile(f)
        rows.tofile(f)
        aux.tofile(f)


def read_snp_dict(path: str) -> SnpDict:
    with open(path, "rb") as f:
        hdr = np.fromfile(f, "<u8", 2)
        if hdr.size != 2:
            _format_err(path, "missing 16-byte dictionary header")
        n, m = hdr
        rows = np.fromfile(f, _SNP_ROW, int(n))
        if rows.size != int(n):
            _format_err(path, f"header promises {n} dict rows, file holds "
                              f"{rows.size}")
        aux = np.fromfile(f, _SNP_AUX_ROW, int(m))
        if aux.size != int(m):
            _format_err(path, f"header promises {m} aux rows, file holds "
                              f"{aux.size}")
    return SnpDict(
        kmers=rows["kmer"].copy(), pos=rows["pos"].copy(),
        snp=rows["snp"].copy(), flag=rows["flag"].copy(),
        ref_freq=rows["rf"].copy(), alt_freq=rows["af"].copy(),
        aux_kmer=aux["kmer"].copy(), aux_pos=aux["cols"]["pos"].copy(),
        aux_snp=aux["cols"]["snp"].copy(), aux_rf=aux["cols"]["rf"].copy(),
        aux_af=aux["cols"]["af"].copy())


def write_sdsl_bf(path: str, bv: BitVector) -> None:
    cap_words = ((bv.bits + 63) // 64 + 7) // 8 * 8  # sdsl 64-byte alignment
    with open(path, "wb") as f:
        np.array([bv.bits], "<u8").tofile(f)
        bv.words.astype("<u8").tofile(f)
        pad = cap_words - bv.words.shape[0]
        if pad > 0:
            np.zeros(pad, "<u8").tofile(f)


def read_sdsl_bf(path: str) -> BitVector:
    with open(path, "rb") as f:
        hdr = np.fromfile(f, "<u8", 1)
        if hdr.size != 1:
            _format_err(path, "missing 8-byte bit-vector header")
        bits = int(hdr[0])
        words = np.fromfile(f, "<u8")
    need = (bits + 63) // 64
    if words.size < need:
        _format_err(path, f"bit vector truncated: header promises {bits} "
                          f"bits ({need} words), file holds {words.size}")
    return BitVector(bits=bits, words=words[:need].copy())
