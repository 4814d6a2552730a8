"""Sharded-dictionary mode: range-partitioned sorted dictionaries and
all-to-all routed probes (port of ``vargeno_tpu/dist/sharded_dict.py``).

For indexes that exceed one device's memory, the sorted dictionaries are
range-partitioned over the mesh, and no hash table is built:

- the ref dictionary into D contiguous row ranges whose boundaries snap to
  hi32 block starts (a block never straddles shards), plus a tail of the
  next rows, so that the reference's small-block scan stride bug
  (qv.cc:359: reads up to 9 * (S - 1) rows past a block start) reads the
  same cells as the unsharded layout does;
- the snp dictionary likewise, with hi24-snapped boundaries (11 * (S - 1)
  tail);
- aux tables, Bloom filters and site tables replicate, one copy per
  distinct device.

A shard keeps its rows as one order-preserving int64 search key a row
(``engine.search.okey``) beside the [pos, flag | info << 8] meta words: 16 B
a row for either dictionary, as the JAX layout's (hi, lo, meta) is for the
ref one. The scans' lo / hi8 test words are read out of the key.

Reads stay data-parallel: each shard runs its own slice of the global batch
and answers every dictionary probe by routing the query to the shard that
owns its key with ``Mesh.all_to_all``; the owner answers with the row's
fields. The per-(src, dst) lane capacity is ``route_factor`` times the
uniform share; truncated lanes count into ``route_overflow``, which
escalation doubles away. Routing needs lockstep: each shard's step runs on
a thread of its own (``Mesh.run_lockstep``), and Q depends only on N and
D, so every shard makes the same collectives in the same order.

Out-of-range indices: JAX drops out-of-range scatters and clamps gathers,
torch raises, so dropped writes go to sink rows that are cut off and every
gather index is clamped.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..config import GenoConfig
from ..core.hashes import M32, widen
from ..engine import search
from ..engine.backend import LocalBackend, ScanResult
from ..engine.batch import make_batch_processor
from ..engine.device_index import (Stager, TorchDeviceIndex, _to_device,
                                   replicated_tables, scan_maxima)
from ..index import store
from ..utils.profiling import span
from .sharding import Mesh, ShardedGenoRunner, device_bytes

REF_TAIL = 9 * 99 + 1     # stride-bug read window beyond a block start
SNP_TAIL = 11 * 99 + 1
PAD_KEY = int(search.np_okey(np.uint32(M32), np.uint32(M32)))  # sorts last
SHARD_ROWS_MAX = 1 << 31   # per-shard row offsets stay below 2^31
REPLICATED = ("aux_all", "ref_bf", "snp_bf", "site_bitmap", "site_dir",
              "site_ra")


@dataclasses.dataclass
class ShardPlan:
    ref_bounds_hi: np.ndarray    # (D,) uint32: first hi32 owned by shard d
    snp_bounds_hi24: np.ndarray  # (D,) uint32


@dataclasses.dataclass
class ShardIndex:
    """One shard of the sharded index, on its device."""

    dix: TorchDeviceIndex       # replicated tables + this shard's meta rows;
                                # no hash table, jumpgate or window table
    ref_key: torch.Tensor       # (m_r,) int64 okey: owned, tail, pad rows
    snp_key: torch.Tensor       # (m_s,)
    ref_bounds: torch.Tensor    # (D,) int64 ShardPlan.ref_bounds_hi
    snp_bounds24: torch.Tensor  # (D,) int64 ShardPlan.snp_bounds_hi24
    ref_owned: int              # rows this shard answers for
    snp_owned: int
    ref_total: int              # owned + real tail rows (the scan limit)
    snp_total: int

    def tensors(self):
        return [t for t in (*vars(self.dix).values(), self.ref_key,
                            self.snp_key, self.ref_bounds, self.snp_bounds24)
                if isinstance(t, torch.Tensor)]


def _key(keys: np.ndarray, i: int):
    return store.read_rows(keys, i, i + 1)[0]


def _snap_boundaries(keys: np.ndarray, D: int, shift: int):
    """Row boundaries of D shards over the sorted uint64 ``keys`` that
    snap to the starts of ``key >> shift`` blocks, and each shard's first
    block value (shard 0's is 0): the JAX function's result over the block
    words. Binary searches that read single keys from the file of a
    memory-mapped column (``store.read_rows``): faults on the map itself
    brought whole files into the process on the card's host."""
    n = keys.shape[0]
    sh = np.uint64(shift)
    rows = [0]
    for d in range(1, D):
        t = (n * d) // D
        if t >= n:
            rows.append(n)
            continue
        first = (_key(keys, t) >> sh) << sh
        lo, hi = 0, t          # the first row whose key >= first
        while lo < hi:
            mid = (lo + hi) // 2
            if _key(keys, mid) < first:
                lo = mid + 1
            else:
                hi = mid
        rows.append(max(lo, rows[-1]))
    rows.append(n)
    firsts = [int(_key(keys, rows[d]) >> sh) if rows[d] < n else 0xFFFFFFFF
              for d in range(D)]
    firsts[0] = 0
    return rows, np.asarray(firsts, np.uint32)


PLACE_ROWS = 1 << 24   # rows of one placement chunk (16 B a row)


@dataclasses.dataclass
class DictRows:
    """One dictionary's sorted rows as the shards take them: shard d holds
    rows ``bounds[d] .. bounds[d + 1] + tail`` (cut at n), padded to
    ``width`` rows."""

    keys: np.ndarray    # (n,) uint64 sorted ascending (may be mmap'd)
    meta: Callable      # (s, e) -> (e - s, 2) uint32 meta words of rows
    bounds: list        # D + 1 row boundaries
    tail: int
    width: int

    def span(self, d: int):
        n = self.keys.shape[0]
        return self.bounds[d], min(self.bounds[d + 1] + self.tail, n)

    def chunks(self, d: int):
        """(offset in the shard, okey (int64), meta (uint32, (c, 2))) of
        shard d's rows, PLACE_ROWS at a time."""
        a, e = self.span(d)
        for s in range(a, e, PLACE_ROWS):
            t = min(s + PLACE_ROWS, e)
            yield (s - a, (store.read_rows(self.keys, s, t)
                           ^ np.uint64(1 << 63)).view(np.int64),
                   self.meta(s, t))


def _dict_rows(keys, meta, D: int, shift: int, tail: int):
    """``DictRows`` of a dictionary (one sentinel row when it is empty,
    as ``host_fields`` pads it), its plan bounds and real rows a shard."""
    if keys.shape[0] == 0:
        keys = np.full(1, np.uint64(0xFFFFFFFFFFFFFFFF))
        meta = lambda s, e: np.asarray([[M32, 1]], np.uint32)  # noqa: E731
    n = keys.shape[0]
    rows, firsts = _snap_boundaries(keys, D, shift)
    sizes = [min(rows[d + 1] + tail, n) - rows[d] for d in range(D)]
    if max(sizes) >= SHARD_ROWS_MAX:
        # the reference caps whole dictionaries at 2^32 rows
        # (src/qv.cc:523-526), so sharded mode needs >= ceil(n / 2^31)
        # devices
        raise ValueError(
            f"shard of {max(sizes)} rows exceeds the 2^31-row "
            f"per-device limit; partition across more devices "
            f"(D={D} given, need >= {-(-n // SHARD_ROWS_MAX)})")
    rows_of = DictRows(keys=keys, meta=meta, bounds=rows, tail=tail,
                       width=max(max(sizes), 1))
    return rows_of, firsts, np.asarray(sizes, np.int32)


@dataclasses.dataclass
class Partition:
    """The host plan of a sharded index: ``replicated_tables`` and the
    statics with ``scan_maxima``, the plan, each shard's owned and
    total (owned + real tail) rows, and both dictionaries' rows, read only
    when a shard is filled."""

    fields: dict
    statics: dict
    plan: ShardPlan
    owned: dict
    totals: dict
    ref: DictRows
    snp: DictRows


def partition_index(index: store.VarGenoIndex, D: int) -> Partition:
    """The host plan of ``index`` over D shards: boundaries snapped to hi32
    (ref) and hi24 (snp) block starts by binary search over the sorted
    keys, the replicated tables, and nothing of the dictionaries' width
    (``place_shards`` reads the rows)."""
    fields, statics = replicated_tables(index)
    ref_scan_max, snp_scan_max = scan_maxima(index, statics)
    statics.update(ref_scan_max=ref_scan_max, snp_scan_max=snp_scan_max)
    r, s = index.ref, index.snp

    def col(a, lo, hi):
        return store.read_rows(a, lo, hi).astype(np.uint32)

    def ref_meta(a, e):
        return np.stack([col(r.pos, a, e), col(r.flag, a, e)], 1)

    def snp_meta(a, e):
        return np.stack([col(s.pos, a, e), col(s.flag, a, e)
                         | (col(s.snp, a, e) << np.uint32(8))], 1)

    ref, ref_firsts, ref_tot = _dict_rows(r.kmers, ref_meta, D, 32,
                                          REF_TAIL)
    snp, snp_firsts24, snp_tot = _dict_rows(s.kmers, snp_meta, D, 40,
                                            SNP_TAIL)

    def owned(rows):
        return np.asarray([rows.bounds[d + 1] - rows.bounds[d]
                           for d in range(D)], np.int32)

    return Partition(
        fields=fields, statics=statics,
        plan=ShardPlan(ref_bounds_hi=ref_firsts,
                       snp_bounds_hi24=snp_firsts24),
        owned=dict(ref=owned(ref), snp=owned(snp)),
        totals=dict(ref=ref_tot, snp=snp_tot), ref=ref, snp=snp)


def _place_rows(rows: DictRows, d: int, dev, stager: Stager):
    """Shard d's key and meta tensors on ``dev``, allocated once and
    filled a chunk at a time through ``stager``; pad rows PAD_KEY and
    0xFFFFFFFF (meta pad rows read as [POS_AMBIGUOUS, flag 0xFF]: no pad
    looks like an unambiguous hit)."""
    key = torch.empty(rows.width, dtype=torch.int64, device=dev)
    meta = torch.empty((rows.width, 2), dtype=torch.int32, device=dev)
    n = 0
    for off, k, m in rows.chunks(d):
        n = off + k.shape[0]
        stager.copy(key[off:n], k)
        stager.copy(meta[off:n], m)
    key[n:] = PAD_KEY
    meta[n:] = -1
    return key, meta


def place_shards(partition: Partition, mesh: Mesh) -> list:
    """The partition's shards that this process holds on the mesh's
    devices (global shards ``mesh.offset ..``): each shard's rows streamed
    onto its own device, replicated tables once per distinct device."""
    p = partition
    statics = p.statics
    repl: dict = {}
    shards = []
    for d, dev in enumerate(mesh.devices, start=mesh.offset):
        if dev not in repl:
            repl[dev] = dict(
                {f: _to_device(p.fields[f], dev) for f in REPLICATED},
                ref_bounds=torch.from_numpy(
                    p.plan.ref_bounds_hi.astype(np.int64)).to(dev),
                snp_bounds24=torch.from_numpy(
                    p.plan.snp_bounds_hi24.astype(np.int64)).to(dev))
        r = repl[dev]
        stager = Stager(dev)
        ref_key, ref_meta = _place_rows(p.ref, d, dev, stager)
        snp_key, snp_meta = _place_rows(p.snp, d, dev, stager)
        stager.finish()

        def empty(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        dix = TorchDeviceIndex(
            both_ht=empty(0, 128), ref_jg=empty(0), snp_jg=empty(0),
            ref_hi=empty(0, 32), ref_lo=empty(0), snp_test=empty(0, 2),
            ref_meta=ref_meta, snp_meta=snp_meta,
            **{f: r[f] for f in REPLICATED},
            snp_bf_bits=int(statics["snp_bf_bits"]),
            ref_bf_bits=int(statics["ref_bf_bits"]),
            n_ref_aux=int(statics["n_ref_aux"]), both_ht_nb=0,
            both_ht_chain=0, ref_win_rows=0,
            # shard blocks are whole global blocks (boundaries snap to key
            # changes), so the global maxima bound the per-shard scans
            ref_scan_max=int(statics["ref_scan_max"]),
            snp_scan_max=int(statics["snp_scan_max"]),
            n_ref_rows=p.ref.width, n_snp_rows=p.snp.width,
            n_sites=int(p.fields["site_ra"].shape[0]))
        shards.append(ShardIndex(
            dix=dix, ref_key=ref_key, snp_key=snp_key,
            ref_bounds=r["ref_bounds"], snp_bounds24=r["snp_bounds24"],
            ref_owned=int(p.owned["ref"][d]), snp_owned=int(p.owned["snp"][d]),
            ref_total=int(p.totals["ref"][d]),
            snp_total=int(p.totals["snp"][d])))
    return shards


class _ShardLocal(LocalBackend):
    """Scans answered over one shard (owned rows + stride tail), its block
    bounds found by sorted search instead of jumpgates."""

    def __init__(self, shard: ShardIndex, stride_bug: bool, S: int):
        super().__init__(shard.dix, stride_bug, S)
        self.shard = shard

    def _ref_limit(self) -> int:
        return self.shard.ref_total

    def _snp_limit(self) -> int:
        return self.shard.snp_total

    def _ref_lo(self, idx):
        return search.key_lo(self.shard.ref_key[idx])

    def _snp_test(self, idx):
        k = self.shard.snp_key[idx]
        return search.key_lo(k), search.key_hi(k) & 0xFF

    # The JAX _ShardLocal also masks scan hits with ``start < owned``: a
    # block starting past the owned rows has size 0 here already, so its
    # scan has no lanes and the mask changes nothing.

    def _ref_block_bounds(self, q_hi):
        keys, owned = self.shard.ref_key, self.shard.ref_owned
        blo = search.lower_bound(keys, q_hi, torch.zeros_like(q_hi))
        bhi = torch.where(q_hi == M32, owned, search.block_end(keys, q_hi))
        return blo, bhi.clamp(max=owned) - blo.clamp(max=owned)

    def _snp_block_bounds(self, q_hi24):
        keys, owned = self.shard.snp_key, self.shard.snp_owned
        first = q_hi24 << 8
        slo = search.lower_bound(keys, first, torch.zeros_like(q_hi24))
        shi = torch.where(q_hi24 == 0xFFFFFF, owned,
                          search.block_end(keys, first | 0xFF))
        return slo, shi.clamp(max=owned) - slo.clamp(max=owned)


class RoutedBackend:
    """Answers the step's probes by routing each query to the shard that
    owns its key (``Mesh.all_to_all``); the owner answers from its rows."""

    def __init__(self, shard: ShardIndex, mesh: Mesh, rank: int,
                 stride_bug: bool, block_size_threshold: int,
                 scan_slots: int = 16, route_factor: float = 2.2):
        self.shard = shard
        self.dix = shard.dix
        self.mesh = mesh
        self.rank = rank
        self.D = mesh.size
        self.S = block_size_threshold
        self.stride_bug = stride_bug
        # the step's scan grid is scan_slots wide for either dictionary
        self.scan_slots = self.ref_scan_slots = self.snp_scan_slots = \
            scan_slots
        self.route_factor = route_factor
        self.route_overflow = None   # valid lanes dropped, from the first
                                     # routed query on

    def _ref_owner(self, q_hi):
        return torch.searchsorted(self.shard.ref_bounds, q_hi,
                                  side="right") - 1

    def _snp_owner(self, q_hi):
        return torch.searchsorted(self.shard.snp_bounds24, q_hi >> 8,
                                  side="right") - 1

    def _route(self, is_ref: bool, q_hi, valid, send_fields, answer_fn,
               R: int = 1):
        """Route (N,) queries to the owners of their keys (``q_hi`` in the
        ref or the SNP dictionary); lanes with valid False go nowhere and
        read zero answers. ``answer_fn`` gets the D*Q received queries'
        fields and returns its answer fields, R values a query,
        query-major. All fields ride one (D, Q, F) int64 buffer each way.
        Returns the answers ((N,) each, or (N, R)) and the count of valid
        queries dropped for want of lanes. The exchange on each side of
        ``answer_fn`` is the span ``step.route``; the owner's search is
        the caller's."""
        N = q_hi.shape[0]
        D = self.D
        dev = q_hi.device
        Q = max(16, -(-int(self.route_factor * N) // D))
        F = len(send_fields)
        with span("step.route"):
            owner = self._ref_owner(q_hi) if is_ref else self._snp_owner(q_hi)
            owner = torch.where(valid, owner, D)  # invalid lanes -> bucket D
            order = torch.argsort(owner, stable=True)
            so = owner[order]
            start = torch.searchsorted(so, torch.arange(D + 1, device=dev))
            posg = torch.arange(N, device=dev) - start[so]
            ok = posg < Q
            slot = torch.where(ok, posg, Q)
            # row D and column Q are sinks for the lanes JAX drops
            buf = torch.zeros((D + 1, Q + 1, F), dtype=torch.int64,
                              device=dev)
            buf[so, slot] = torch.stack([f.long() for f in send_fields],
                                        -1)[order]
            recv = self.mesh.all_to_all(self.rank, buf[:D, :Q])  # (D, Q, F)
            recv = recv.reshape(D * Q, F).unbind(1)
        answers = answer_fn(*recv)
        with span("step.route"):
            Fa = len(answers)
            rows = torch.stack([a.long() for a in answers], -1)
            back = self.mesh.all_to_all(self.rank,
                                        rows.reshape(D, Q * R, Fa))
            back = back.reshape(D, Q, R, Fa)

            inv = torch.empty_like(slot)
            inv[order] = slot
            got = valid & (inv < Q)
            got_rows = back[owner.clamp(max=D - 1), inv.clamp(max=Q - 1)]
            # (N, R, Fa)
            got_rows = torch.where(got[:, None, None], got_rows, 0)
            outs = tuple(got_rows[:, 0, i] if R == 1 else got_rows[..., i]
                         for i in range(Fa))
            route_ovf = (~ok & (so < D)).sum()
            self.route_overflow = route_ovf if self.route_overflow is None \
                else self.route_overflow + route_ovf
        return outs, route_ovf

    # --- exact queries ---

    @staticmethod
    def _local_exact(keys, meta, owned: int, q_hi, q_lo, with_info: bool):
        q = search.okey(q_hi, q_lo)
        i = torch.searchsorted(keys, q)          # search.lower_bound
        ic = i.clamp(max=keys.shape[0] - 1)
        hit = (keys[ic] == q) & (i < owned)
        m = widen(meta[ic])
        out = (hit, m[:, 0], m[:, 1] & 0xFF)
        return out + ((m[:, 1] >> 8) & 0xFF,) if with_info else out

    def exact_ref(self, q_hi, q_lo, valid=None):
        """(hit, pos, flag)"""
        shp = q_hi.shape
        sh = self.shard
        v = (torch.ones(q_hi.numel(), dtype=torch.bool, device=q_hi.device)
             if valid is None else valid.reshape(-1))

        def ans(qh, ql):
            return self._local_exact(sh.ref_key, sh.dix.ref_meta,
                                     sh.ref_owned, qh, ql, False)

        (hit, pos, flag), _ = self._route(
            True, q_hi.reshape(-1), v,
            (q_hi.reshape(-1), q_lo.reshape(-1)), ans)
        return (hit != 0).reshape(shp), pos.reshape(shp), flag.reshape(shp)

    def exact_snp(self, q_hi, q_lo, valid=None):
        """(hit, pos, info, flag)"""
        shp = q_hi.shape
        sh = self.shard
        v = (torch.ones(q_hi.numel(), dtype=torch.bool, device=q_hi.device)
             if valid is None else valid.reshape(-1))

        def ans(qh, ql):
            return self._local_exact(sh.snp_key, sh.dix.snp_meta,
                                     sh.snp_owned, qh, ql, True)

        (hit, pos, flag, info), _ = self._route(
            False, q_hi.reshape(-1), v,
            (q_hi.reshape(-1), q_lo.reshape(-1)), ans)
        return ((hit != 0).reshape(shp), pos.reshape(shp),
                info.reshape(shp), flag.reshape(shp))

    def ref_block_size(self, q_hi):
        shp = q_hi.shape
        sh = self.shard

        def ans(qh):
            start = search.lower_bound(sh.ref_key, qh, torch.zeros_like(qh))
            end = torch.where(qh == M32, sh.ref_owned,
                              search.block_end(sh.ref_key, qh))
            return (end.clamp(max=sh.ref_owned)
                    - start.clamp(max=sh.ref_owned),)

        q = q_hi.reshape(-1)
        (bs,), _ = self._route(True, q, torch.ones_like(q, dtype=torch.bool),
                               (q,), ans)
        return bs.reshape(shp)

    # --- routed block scans ---

    def _scan(self, is_ref: bool, q_hi, q_lo, active) -> ScanResult:
        R = self.scan_slots
        ovf_box = [None]

        def ans(qh, ql, act):
            local = _ShardLocal(self.shard, self.stride_bug, self.S)
            res = (local.ref_scan(qh, ql, act != 0) if is_ref
                   else local.snp_scan(qh, ql, act != 0))
            M = qh.shape[0]
            tgt = torch.cumsum(res.hit, 1) - 1
            keep = res.hit & (tgt < R)
            # this shard's scan overflow on the queries it answered
            ovf_box[0] = (res.hit.sum() - keep.sum()) + res.overflow
            scat = torch.where(keep, tgt, R)   # column R is the sink

            def cp(arr):
                out = torch.zeros((M, R + 1), dtype=torch.int64,
                                  device=qh.device)
                out.scatter_(1, scat, torch.where(keep, arr.long(), 0))
                return out[:, :R].reshape(M * R)

            return (cp(keep), cp(res.pos), cp(res.flag), cp(res.info),
                    cp(res.nb_hi.expand_as(res.hit)), cp(res.nb_lo),
                    cp(res.diff))

        outs, route_ovf = self._route(is_ref, q_hi, active,
                                      (q_hi, q_lo, active), ans, R=R)
        hit, pos, flag, info, nbhi, nblo, diff = outs
        return ScanResult(hit=hit != 0, pos=pos, flag=flag, info=info,
                          nb_hi=nbhi, nb_lo=nblo, diff=diff,
                          overflow=ovf_box[0] + route_ovf)

    def ref_scan(self, q_hi, q_lo, active) -> ScanResult:
        return self._scan(True, q_hi, q_lo, active)

    def snp_scan(self, q_hi, q_lo, active) -> ScanResult:
        return self._scan(False, q_hi, q_lo, active)


class ShardedDictGenoRunner(ShardedGenoRunner):
    """Data-parallel reads over range-partitioned dictionaries on one mesh.
    Subclasses the data-parallel runner and keeps its whole host loop
    (escalation included: ``route_factor`` and ``route_scan_slots`` double
    through GenoConfig); only the index layout, the backend
    (RoutedBackend) and the lockstep dispatch differ."""

    def _prepare_shards(self, index, config) -> list:
        return place_shards(partition_index(index, self.D), self.mesh)

    @staticmethod
    def _dix_of(shard):
        return shard.dix

    def _processor(self, cfg: GenoConfig, rank: int):
        shard, mesh = self.shards[rank], self.mesh

        def factory(_dix):
            return RoutedBackend(shard, mesh, mesh.offset + rank,
                                 cfg.replicate_stride_bug,
                                 cfg.block_size_threshold,
                                 scan_slots=cfg.route_scan_slots,
                                 route_factor=cfg.route_factor)

        return make_batch_processor(shard.dix, cfg, self.vote, factory)

    def _run_shards(self, fns) -> list:
        """Every collective of a step meets all shards: run the local ones
        in lockstep, a thread each (one needs none)."""
        if self.local_D == 1:
            return super()._run_shards(fns)
        return self.mesh.run_lockstep(fns)

    def device_bytes(self) -> int:
        return device_bytes(t for s in self.shards for t in s.tensors())
