"""Device-resident index (port of ``vargeno_tpu/engine/device_index.py``,
no longer a pure copy: its tables must equal the JAX
``build_device_index(host_only=True)``'s, which tests/test_torch_index.py
and, through the sharded dictionary, tests/test_torch_sharded_dict.py and
tests/test_torch_wgs_stream.py hold).

The host derivation (``host_fields``) turns a VarGenoIndex into the engine's
tables exactly as the JAX package's ``build_device_index(host_only=True)``
does, minus the retired one-bit prefilter (``both_pf``). Unlike the JAX
derivation it reads the dictionary columns in chunks where it only needs a
maximum, and the sharded dictionary takes only its ``replicated_tables``
and ``scan_maxima``: none of the full-width dictionary tables. ``from_numpy``
carries such a table dict -- the port's or the JAX package's -- onto a torch
device as a ``TorchDeviceIndex``. Every uint32 table is stored as its int32
bit pattern (a zero-copy view on the host); gathered words are widened to
int64 and masked where arithmetic needs the unsigned value.

Only what the single-device step reads is moved: the site arrays used by
calling (site_pos/ref/alt), the rank directory (replaced by site_dir) and
the raw snp key columns stay on the host.

Derived tables are cached on disk in ``<prefix>.vgt/derived_torch/`` so the
port and the JAX package (``derived/``) never overwrite each other's files.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..index.store import VarGenoIndex, read_rows

# tables the step gathers from (all uint32 on the host)
DEVICE_FIELDS = ("both_ht", "ref_jg", "snp_jg", "ref_hi", "ref_lo",
                 "ref_meta", "aux_all", "snp_meta", "snp_test", "ref_bf",
                 "snp_bf", "site_bitmap", "site_dir", "site_ra")
STATIC_FIELDS = ("snp_bf_bits", "ref_bf_bits", "n_ref_aux", "both_ht_nb",
                 "both_ht_chain", "ref_win_rows", "ref_scan_max",
                 "snp_scan_max", "n_ref_rows", "n_snp_rows")


@dataclasses.dataclass
class TorchDeviceIndex:
    both_ht: torch.Tensor     # (nb, 128) combined ref+snp bucket rows
    ref_jg: torch.Tensor      # (2^24 + 1,) hi24 prefix counts of ref_hi
    snp_jg: torch.Tensor      # (2^24 + 1,) hi24 prefix counts of snp keys
    ref_hi: torch.Tensor      # (n/32, 32) ref key hi words (window gathers)
    ref_lo: torch.Tensor      # (n,) ref key lo words
    ref_meta: torch.Tensor    # (n, 2) [pos, flag]
    aux_all: torch.Tensor     # (m_r + m_s, 10, 2) [pos, snp_info]
    snp_meta: torch.Tensor    # (n, 2) [pos, flag | info<<8]
    snp_test: torch.Tensor    # (n, 2) [lo, hi & 0xFF]
    ref_bf: torch.Tensor      # ref Bloom filter words, LSB-first
    snp_bf: torch.Tensor      # snp Bloom filter words
    site_bitmap: torch.Tensor  # genome-position bitmap of SNP sites
    site_dir: torch.Tensor    # (nwords, 4) [bm, rank, bm_next, rank_next]
    site_ra: torch.Tensor     # (s,) ref | alt<<8
    snp_bf_bits: int
    ref_bf_bits: int
    n_ref_aux: int
    both_ht_nb: int
    both_ht_chain: int
    ref_win_rows: int
    ref_scan_max: int
    snp_scan_max: int
    n_ref_rows: int
    n_snp_rows: int
    n_sites: int

    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in DEVICE_FIELDS)


STAGE_BYTES = 1 << 28   # one pinned staging buffer of a Stager


class Stager:
    """Copies host arrays into slices of tensors on ``device``. On the CPU
    directly; to a CUDA device in STAGE_BYTES pieces through two pinned
    buffers in turn, each refilled once its copy to the card is done: the
    host never holds a whole copy of what it sends (a 34 GB hash table, a
    memory-mapped index), and the card's copies run at the pinned rate
    while the host fills the other buffer. ``finish`` waits for the last
    copies; a Stager is used once."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.bufs = [None, None]
        self.done = [None, None]
        self.turn = 0

    def copy(self, dst: torch.Tensor, src: np.ndarray) -> None:
        """``dst`` (a contiguous tensor on the device) takes the bytes of
        ``src`` (as many)."""
        src = np.ascontiguousarray(src).reshape(-1).view(np.uint8)
        out = dst.view(-1).view(torch.uint8)
        if out.numel() != src.shape[0]:
            raise ValueError(f"{src.shape[0]} B into {out.numel()} B")
        if self.device.type == "cpu":
            out.numpy()[:] = src
            return
        n = src.shape[0]
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            for s in range(0, n, STAGE_BYTES):
                k = self.turn
                self.turn ^= 1
                if self.done[k] is not None:
                    self.done[k].synchronize()
                m = min(STAGE_BYTES, n - s)
                if self.bufs[k] is None or self.bufs[k].numel() < m:
                    self.bufs[k] = torch.empty(m, dtype=torch.uint8,
                                               pin_memory=True)
                self.bufs[k].numpy()[:m] = src[s:s + m]
                out[s:s + m].copy_(self.bufs[k][:m], non_blocking=True)
                self.done[k] = torch.cuda.Event()
                self.done[k].record(stream)

    def finish(self) -> None:
        for ev in self.done:
            if ev is not None:
                ev.synchronize()
        self.done = [None, None]
        self.bufs = [None, None]


def upload_array(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor of the same dtype and bits on ``device``.
    On the CPU without a copy (a read-only memory map is copied); to a
    CUDA device through a ``Stager``."""
    a = np.ascontiguousarray(a)
    if device.type == "cpu":
        return torch.from_numpy(a if a.flags.writeable else a.copy())
    out = torch.empty(a.shape, device=device,
                      dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype)
    if a.size:
        st = Stager(device)
        st.copy(out, a)
        st.finish()
    return out


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 host array -> int32 tensor with the same bits on ``device``
    (``upload_array``)."""
    a = np.ascontiguousarray(a)
    if a.dtype != np.uint32:
        raise TypeError(f"device table must be uint32, got {a.dtype}")
    return upload_array(a.view(np.int32), device)


def from_numpy(fields: dict, statics: dict,
               device: torch.device | str) -> TorchDeviceIndex:
    """Carry host tables onto ``device``. ``fields`` maps table names to
    uint32 numpy arrays (extra names, such as the JAX package's both_pf, are
    ignored); ``statics`` holds the integer metadata. ``ref_hi`` may be flat
    or (n/32, 32)."""
    device = torch.device(device)
    t = {f: _to_device(fields[f], device) for f in DEVICE_FIELDS}
    t["ref_hi"] = t["ref_hi"].reshape(-1, 32)
    s = {f: int(statics[f]) for f in STATIC_FIELDS}
    return TorchDeviceIndex(**t, **s, n_sites=int(t["site_ra"].shape[0]))


SCAN_ROWS = 1 << 26   # rows of a column read at a time for a maximum


def max_run(sorted_keys, shift: int = 0):
    """Longest run of equal values (of ``key >> shift``) in a sorted array,
    computed in chunks of SCAN_ROWS rows."""
    chunk = SCAN_ROWS
    n = sorted_keys.shape[0]
    if n == 0:
        return 1
    best = 1
    carry = 1
    for s in range(0, n, chunk):
        seg = read_rows(sorted_keys, max(s - 1, 0), s + chunk)
        if shift:
            seg = seg >> np.asarray(shift, seg.dtype)
        neq = seg[1:] != seg[:-1]
        b = np.flatnonzero(neq)
        if b.size == 0:
            carry += seg.shape[0] - 1
            best = max(best, carry)
            continue
        carry += int(b[0])
        best = max(best, carry)
        if b.size > 1:
            best = max(best, int(np.diff(b).max()))
        carry = seg.shape[0] - 1 - int(b[-1])
    return max(best, carry, 1)


_DERIVED_VERSION = 5  # same table layouts as the JAX package's version 5


class _DerivedCache:
    """Best-effort disk cache of the expensive derived tables (bucket hash
    table, jumpgates) inside ``<prefix>.vgt/derived_torch/``, keyed on row
    counts + layout version."""

    def __init__(self, index, n_ref: int, n_snp: int):
        self.dir = None
        self.meta = None
        prefix = getattr(index, "prefix", None)
        if prefix and os.path.isdir(prefix + ".vgt"):
            self.dir = os.path.join(prefix + ".vgt", "derived_torch")
        self._key = dict(version=_DERIVED_VERSION, n_ref=n_ref, n_snp=n_snp)
        path = self.dir and os.path.join(self.dir, "meta.json")
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    m = json.load(f)
                if all(m.get(k) == v for k, v in self._key.items()):
                    self.meta = m
            except (OSError, ValueError):
                pass

    def has(self, *names: str) -> bool:
        if self.meta is None:
            return False
        return all(n in self.meta or self.meta.get("files_" + n)
                   for n in names)

    def load(self, name: str) -> np.ndarray:
        return np.load(os.path.join(self.dir, name + ".npy"), mmap_mode="r")

    def save(self, meta: dict | None = None, **arrays) -> None:
        if self.dir is None:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            # temporary names of this process's own: the processes of a
            # cluster may save the same tables at once
            for name, arr in arrays.items():
                tmp = os.path.join(self.dir, f"{name}.npy.{os.getpid()}.tmp")
                with open(tmp, "wb") as f:
                    np.save(f, np.ascontiguousarray(arr))
                os.replace(tmp, os.path.join(self.dir, name + ".npy"))
            m = dict(self.meta) if self.meta is not None else dict(self._key)
            for name in arrays:
                m["files_" + name] = True
            if meta:
                m.update(meta)
            tmp = os.path.join(self.dir, f"meta.json.{os.getpid()}.tmp")
            with open(tmp, "w") as f:
                json.dump(m, f)
            os.replace(tmp, os.path.join(self.dir, "meta.json"))
            self.meta = m
        except OSError:
            pass  # cache is best-effort (read-only index dir, disk full)


def max_unambiguous_pos(ref) -> int:
    """The largest position of an unambiguous ref row (flag 0), read in
    chunks of SCAN_ROWS rows of the (memory-mapped) columns."""
    best = 0
    chunk = SCAN_ROWS
    for s in range(0, ref.pos.shape[0], chunk):
        p, f = read_rows(ref.pos, s, s + chunk), read_rows(ref.flag, s,
                                                            s + chunk)
        best = max(best, int(p[f == 0].max(initial=0)))
    return best


def site_tables(sites, max_pos: int):
    """The genome-position bitmap of the sites (max_pos + 33 bits) and its
    rank directory: a (words, 4) row [bitmap, rank, next bitmap, next
    rank] a word."""
    nbits = max_pos + 33
    nw = (nbits + 31) // 32
    bitmap = np.zeros(nw, np.uint32)
    sp = sites.pos.astype(np.int64)
    np.bitwise_or.at(bitmap, sp >> 5,
                     (np.uint32(1) << (sp & 31).astype(np.uint32)))
    rank = np.zeros(nw, np.int32)   # sites before each word
    np.cumsum(np.bitwise_count(bitmap[:-1]), dtype=np.int32, out=rank[1:])
    rank = rank.view(np.uint32)
    site_dir = np.zeros((nw, 4), np.uint32)
    site_dir[:, 0] = bitmap
    site_dir[:, 1] = rank
    site_dir[:-1, 2] = bitmap[1:]
    site_dir[:-1, 3] = rank[1:]
    return bitmap, site_dir


def _pad1(a, fill):
    """An empty dictionary's column as one sentinel row that never produces
    an event."""
    if a.shape[0] == 0:
        return np.full((1,) + a.shape[1:], fill, a.dtype)
    return a


def replicated_tables(index: VarGenoIndex):
    """The tables that do not grow with the dictionaries, which every shard
    of the sharded dictionary holds whole: the site bitmap and its rank
    directory (up to the largest unambiguous position, read in chunks), the
    aux rows, the Bloom words, and the sites' REF/ALT. Returns (fields:
    name -> numpy, statics: the Bloom bits, aux rows and row counts)."""
    sites = index.sites

    max_pos = max_unambiguous_pos(index.ref)
    if sites.pos.size:
        max_pos = max(max_pos, int(sites.pos.max()))
    bitmap, site_dir = site_tables(sites, max_pos)

    ref_aux_a = _pad1(index.ref.aux, 0)
    snp_aux_pos_a = _pad1(index.snp.aux_pos, 0)
    snp_aux_snp_a = _pad1(index.snp.aux_snp, 0)
    site_ref_a = _pad1(sites.ref, 0)
    site_alt_a = _pad1(sites.alt, 0)
    site_ra = (site_ref_a.astype(np.uint32)
               | (site_alt_a.astype(np.uint32) << np.uint32(8)))
    aux_all = np.concatenate([
        np.stack([ref_aux_a.astype(np.uint32),
                  np.zeros_like(ref_aux_a, np.uint32)], axis=-1),
        np.stack([snp_aux_pos_a.astype(np.uint32),
                  snp_aux_snp_a.astype(np.uint32)], axis=-1)])
    statics = dict(
        snp_bf_bits=index.snp_bf.bits, ref_bf_bits=index.ref_bf.bits,
        n_ref_aux=int(ref_aux_a.shape[0]),
        n_ref_rows=max(int(index.ref.kmers.shape[0]), 1),
        n_snp_rows=max(int(index.snp.kmers.shape[0]), 1))
    fields = dict(aux_all=aux_all, ref_bf=index.ref_bf.as_u32(),
                  snp_bf=index.snp_bf.as_u32(), site_bitmap=bitmap,
                  site_dir=site_dir, site_ra=site_ra)
    return fields, statics


def _cache_of(index: VarGenoIndex, statics: dict) -> "_DerivedCache":
    return _DerivedCache(index, n_ref=statics["n_ref_rows"],
                         n_snp=statics["n_snp_rows"])


def scan_maxima(index: VarGenoIndex, statics: dict) -> tuple:
    """(ref_scan_max, snp_scan_max): the largest block of ref rows sharing
    their top 32 key bits and of SNP rows sharing their top 24, read in
    chunks of the (memory-mapped) keys -- the jumpgates' block maxima
    without the jumpgates -- and kept in the derived cache. ``statics``:
    ``replicated_tables``'s."""
    cache = _cache_of(index, statics)
    if cache.has("ref_scan_max", "snp_scan_max"):
        return cache.meta["ref_scan_max"], cache.meta["snp_scan_max"]
    got = (max_run(index.ref.kmers, shift=32),
           max_run(index.snp.kmers, shift=40))
    cache.save(meta=dict(ref_scan_max=got[0], snp_scan_max=got[1]))
    return got


def host_fields(index: VarGenoIndex, ht_target_load: float = 0.5):
    """The engine's host tables, as the JAX package's
    ``build_device_index(index, host_only=True)`` derives them (without the
    retired prefilter): ``replicated_tables`` and the tables over the
    dictionaries' rows. Returns (fields: name -> numpy, statics: dict);
    ``fields`` also holds the padded ``snp_hi`` words, which no device
    table keeps."""
    fields, statics = replicated_tables(index)
    cache = _cache_of(index, statics)

    def u32pair(k):
        return ((k >> np.uint64(32)).astype(np.uint32),
                (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    ref_hi, ref_lo = u32pair(index.ref.kmers)
    snp_hi, snp_lo = u32pair(index.snp.kmers)

    ref_pos_a, ref_flag_a = index.ref.pos, index.ref.flag
    snp_pos_a, snp_info_a, snp_flag_a = (index.snp.pos, index.snp.snp,
                                         index.snp.flag)
    if ref_hi.shape[0] == 0:
        ref_hi = _pad1(ref_hi, 0xFFFFFFFF)
        ref_lo = _pad1(ref_lo, 0xFFFFFFFF)
        ref_pos_a = _pad1(ref_pos_a, 0xFFFFFFFF)
        ref_flag_a = _pad1(ref_flag_a, 1)
    if snp_hi.shape[0] == 0:
        snp_hi = _pad1(snp_hi, 0xFFFFFFFF)
        snp_lo = _pad1(snp_lo, 0xFFFFFFFF)
        snp_pos_a = _pad1(snp_pos_a, 0xFFFFFFFF)
        snp_info_a = _pad1(snp_info_a, 0)
        snp_flag_a = _pad1(snp_flag_a, 1)

    from .hashtable import HostHashTable, build_hash_table

    tag = ("%g" % ht_target_load).replace(".", "p")
    ht_name = f"both_ht_{tag}"
    if cache.has(ht_name, f"both_nb_{tag}", f"both_chain_{tag}"):
        both_tab = HostHashTable(table=cache.load(ht_name),
                                 nb=cache.meta[f"both_nb_{tag}"],
                                 chain=cache.meta[f"both_chain_{tag}"])
    else:
        both_tab = build_hash_table(
            np.concatenate([ref_hi, snp_hi]),
            np.concatenate([ref_lo, snp_lo]),
            np.concatenate([ref_pos_a, snp_pos_a]),
            np.concatenate([ref_flag_a, snp_flag_a | np.uint8(0x80)]),
            np.concatenate([np.zeros_like(ref_flag_a), snp_info_a]),
            target_load=ht_target_load)
        cache.save(**{ht_name: both_tab.table},
                   meta={f"both_nb_{tag}": both_tab.nb,
                         f"both_chain_{tag}": both_tab.chain})

    def jumpgate24(keys_hi_sorted, shift: int):
        """jg[h] = first row whose (key >> shift) >= h, plus the largest
        hi24 block size."""
        bounds = np.arange((1 << 24) + 1, dtype=np.uint64) << np.uint64(
            shift)
        bounds = np.minimum(bounds, np.uint64(0xFFFFFFFF)).astype(
            np.uint32)
        jg64 = np.searchsorted(keys_hi_sorted, bounds, side="left")
        jg64[-1] = keys_hi_sorted.shape[0]
        maxblk = int(np.diff(jg64).max(initial=1))
        return jg64.astype(np.uint32), maxblk

    if cache.has("ref_jg", "snp_jg", "ref_win_rows", "ref_scan_max",
                   "snp_scan_max"):
        ref_jg = cache.load("ref_jg")
        snp_jg = cache.load("snp_jg")
        ref_win_rows = cache.meta["ref_win_rows"]
        ref_scan_max = cache.meta["ref_scan_max"]
        snp_scan_max = cache.meta["snp_scan_max"]
    else:
        ref_jg, ref_maxblk = jumpgate24(ref_hi, 8)
        snp_jg, snp_maxblk24 = jumpgate24(snp_hi, 8)
        ref_win_rows = max(1, (max(ref_maxblk, 1) + 62) // 32)
        ref_scan_max = max_run(ref_hi)            # hi32 blocks
        snp_scan_max = max(1, int(snp_maxblk24))  # snp blocks = hi24 blocks
        cache.save(meta=dict(ref_win_rows=ref_win_rows,
                             ref_scan_max=ref_scan_max,
                             snp_scan_max=snp_scan_max),
                   ref_jg=ref_jg, snp_jg=snp_jg)

    def pad32(a):
        """Zero-pad rows to a multiple of 32 (reads in the pad return 0,
        the engine's out-of-dictionary semantics), so ref_hi reshapes to
        (n/32, 32) for the window gathers."""
        p = -a.shape[0] % 32
        if p == 0:
            return a
        return np.concatenate([a, np.zeros((p,) + a.shape[1:], a.dtype)])

    ref_hi, ref_lo = pad32(ref_hi), pad32(ref_lo)
    ref_pos_a, ref_flag_a = pad32(ref_pos_a), pad32(ref_flag_a)
    snp_lo, snp_hi = pad32(snp_lo), pad32(snp_hi)
    snp_pos_a, snp_info_a, snp_flag_a = (pad32(snp_pos_a),
                                         pad32(snp_info_a),
                                         pad32(snp_flag_a))
    ref_meta = np.stack([ref_pos_a.astype(np.uint32),
                         ref_flag_a.astype(np.uint32)], axis=1)
    snp_meta = np.stack(
        [snp_pos_a.astype(np.uint32),
         snp_flag_a.astype(np.uint32)
         | (snp_info_a.astype(np.uint32) << np.uint32(8))], axis=1)
    snp_test = np.stack([snp_lo, snp_hi & np.uint32(0xFF)], axis=1)

    fields.update(
        both_ht=both_tab.table, ref_jg=ref_jg, snp_jg=snp_jg,
        ref_hi=ref_hi, ref_lo=ref_lo, ref_meta=ref_meta,
        snp_meta=snp_meta, snp_test=snp_test, snp_hi=snp_hi)
    statics.update(
        both_ht_nb=both_tab.nb, both_ht_chain=both_tab.chain,
        ref_win_rows=ref_win_rows, ref_scan_max=ref_scan_max,
        snp_scan_max=snp_scan_max)
    return fields, statics


def build_device_index(index: VarGenoIndex, device: torch.device | str,
                       ht_target_load: float = 0.5) -> TorchDeviceIndex:
    """Derive the host tables and carry them onto ``device``."""
    return from_numpy(*host_fields(index, ht_target_load), device)
