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
import numpy as np
import torch

from ..config import GenoConfig
from ..core.hashes import M32, widen
from ..engine import search
from ..engine.backend import LocalBackend, ScanResult
from ..engine.batch import make_batch_processor
from ..engine.device_index import (TorchDeviceIndex, _to_device, host_fields,
                                   upload_array)
from ..index import store
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


def _snap_boundaries(keys_hi: np.ndarray, D: int):
    n = keys_hi.shape[0]
    rows = [0]
    for d in range(1, D):
        t = (n * d) // D
        if t >= n:
            rows.append(n)
            continue
        hv = keys_hi[t]
        b = int(np.searchsorted(keys_hi, hv, side="left"))
        rows.append(max(b, rows[-1]))
    rows.append(n)
    firsts = []
    for d in range(D):
        firsts.append(int(keys_hi[rows[d]]) if rows[d] < n else 0xFFFFFFFF)
    firsts[0] = 0
    return rows, np.asarray(firsts, np.uint32)


def partition_index(index: store.VarGenoIndex, D: int):
    """Host plan. Returns (base, stacked, plan, owned, totals): base =
    (fields, statics) of ``host_fields`` without lookup tables (the
    replicated tables come from it); stacked = per-shard (D, m) arrays
    ``ref_key`` / ``snp_key`` (int64 okey, pad rows PAD_KEY) and
    ``ref_meta`` / ``snp_meta`` ((D, m, 2) uint32, pad rows 0xFFFFFFFF);
    owned / totals = per-shard row counts of each dictionary."""
    fields, statics = host_fields(index, tables=False)
    nr, ns = statics["n_ref_rows"], statics["n_snp_rows"]
    # trim the 32-row alignment padding: shards partition true rows only
    ref_hi = fields.pop("ref_hi")[:nr]
    ref_lo = fields.pop("ref_lo")[:nr]
    snp_hi = fields.pop("snp_hi")[:ns]
    snp_lo = fields.pop("snp_test")[:ns, 0]
    ref_rows, ref_firsts = _snap_boundaries(ref_hi, D)
    snp_rows, snp_firsts24 = _snap_boundaries(snp_hi >> np.uint32(8), D)

    def shard_stack(arr, rows, tail, fill, n):
        sizes = [min(rows[d + 1] + tail, n) - rows[d] for d in range(D)]
        if max(sizes) >= SHARD_ROWS_MAX:
            # the reference caps whole dictionaries at 2^32 rows
            # (src/qv.cc:523-526), so sharded mode needs >= ceil(n / 2^31)
            # devices
            raise ValueError(
                f"shard of {max(sizes)} rows exceeds the 2^31-row "
                f"per-device limit; partition across more devices "
                f"(D={D} given, need >= {-(-n // SHARD_ROWS_MAX)})")
        m = max(max(sizes), 1)
        out = np.full((D, m) + arr.shape[1:], fill, arr.dtype)
        for d in range(D):
            seg = arr[rows[d]: min(rows[d + 1] + tail, n)]
            out[d, : seg.shape[0]] = seg
        return out, np.asarray(sizes, np.int32)

    stacked = {}
    stacked["ref_key"], ref_tot = shard_stack(
        search.np_okey(ref_hi, ref_lo), ref_rows, REF_TAIL, PAD_KEY, nr)
    del ref_hi, ref_lo
    # meta pad rows read as [POS_AMBIGUOUS, flag 0xFF]: no pad looks like
    # an unambiguous hit
    stacked["ref_meta"], _ = shard_stack(fields.pop("ref_meta")[:nr],
                                         ref_rows, REF_TAIL, M32, nr)
    stacked["snp_key"], snp_tot = shard_stack(
        search.np_okey(snp_hi, snp_lo), snp_rows, SNP_TAIL, PAD_KEY, ns)
    stacked["snp_meta"], _ = shard_stack(fields.pop("snp_meta")[:ns],
                                         snp_rows, SNP_TAIL, M32, ns)
    plan = ShardPlan(ref_bounds_hi=ref_firsts, snp_bounds_hi24=snp_firsts24)
    owned = dict(
        ref=np.asarray([ref_rows[d + 1] - ref_rows[d] for d in range(D)],
                       np.int32),
        snp=np.asarray([snp_rows[d + 1] - snp_rows[d] for d in range(D)],
                       np.int32))
    totals = dict(ref=ref_tot, snp=snp_tot)
    return (fields, statics), stacked, plan, owned, totals


def place_shards(partition, mesh: Mesh) -> list:
    """The partition's shards that this process holds on the mesh's
    devices (global shards ``mesh.offset ..``): shard arrays on their own
    device, replicated tables once per distinct device."""
    (fields, statics), stacked, plan, owned, totals = partition
    repl: dict = {}
    shards = []
    for d, dev in enumerate(mesh.devices, start=mesh.offset):
        if dev not in repl:
            repl[dev] = dict(
                {f: _to_device(fields[f], dev) for f in REPLICATED},
                ref_bounds=torch.from_numpy(
                    plan.ref_bounds_hi.astype(np.int64)).to(dev),
                snp_bounds24=torch.from_numpy(
                    plan.snp_bounds_hi24.astype(np.int64)).to(dev))
        r = repl[dev]

        def empty(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        dix = TorchDeviceIndex(
            both_ht=empty(0, 128), ref_jg=empty(0), snp_jg=empty(0),
            ref_hi=empty(0, 32), ref_lo=empty(0), snp_test=empty(0, 2),
            ref_meta=_to_device(stacked["ref_meta"][d], dev),
            snp_meta=_to_device(stacked["snp_meta"][d], dev),
            **{f: r[f] for f in REPLICATED},
            snp_bf_bits=int(statics["snp_bf_bits"]),
            ref_bf_bits=int(statics["ref_bf_bits"]),
            n_ref_aux=int(statics["n_ref_aux"]), both_ht_nb=0,
            both_ht_chain=0, ref_win_rows=0,
            # shard blocks are whole global blocks (boundaries snap to key
            # changes), so the global maxima bound the per-shard scans
            ref_scan_max=int(statics["ref_scan_max"]),
            snp_scan_max=int(statics["snp_scan_max"]),
            n_ref_rows=stacked["ref_key"].shape[1],
            n_snp_rows=stacked["snp_key"].shape[1],
            n_sites=int(fields["site_ra"].shape[0]))
        shards.append(ShardIndex(
            dix=dix,
            ref_key=upload_array(stacked["ref_key"][d], dev),
            snp_key=upload_array(stacked["snp_key"][d], dev),
            ref_bounds=r["ref_bounds"], snp_bounds24=r["snp_bounds24"],
            ref_owned=int(owned["ref"][d]), snp_owned=int(owned["snp"][d]),
            ref_total=int(totals["ref"][d]),
            snp_total=int(totals["snp"][d])))
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
        self.route_overflow = torch.zeros((), dtype=torch.int64,
                                          device=shard.ref_key.device)

    def _ref_owner(self, q_hi):
        return torch.searchsorted(self.shard.ref_bounds, q_hi,
                                  side="right") - 1

    def _snp_owner(self, q_hi):
        return torch.searchsorted(self.shard.snp_bounds24, q_hi >> 8,
                                  side="right") - 1

    def _route(self, owner, valid, send_fields, answer_fn, R: int = 1):
        """Route (N,) queries to their owners; lanes with valid False go
        nowhere and read zero answers. ``answer_fn`` gets the D*Q received
        queries' fields and returns its answer fields, R values a query,
        query-major. All fields ride one (D, Q, F) int64 buffer each way.
        Returns the answers ((N,) each, or (N, R)) and the count of valid
        queries dropped for want of lanes."""
        N = owner.shape[0]
        D = self.D
        dev = owner.device
        Q = max(16, -(-int(self.route_factor * N) // D))
        owner = torch.where(valid, owner, D)   # invalid lanes -> bucket D
        order = torch.argsort(owner, stable=True)
        so = owner[order]
        start = torch.searchsorted(so, torch.arange(D + 1, device=dev))
        posg = torch.arange(N, device=dev) - start[so]
        ok = posg < Q
        slot = torch.where(ok, posg, Q)
        F = len(send_fields)
        # row D and column Q are sinks for the lanes JAX drops
        buf = torch.zeros((D + 1, Q + 1, F), dtype=torch.int64, device=dev)
        buf[so, slot] = torch.stack([f.long() for f in send_fields],
                                    -1)[order]
        recv = self.mesh.all_to_all(self.rank, buf[:D, :Q])  # (D, Q, F)
        answers = answer_fn(*recv.reshape(D * Q, F).unbind(1))
        Fa = len(answers)
        rows = torch.stack([a.long() for a in answers], -1)
        back = self.mesh.all_to_all(self.rank, rows.reshape(D, Q * R, Fa))
        back = back.reshape(D, Q, R, Fa)

        inv = torch.empty_like(slot)
        inv[order] = slot
        got = valid & (inv < Q)
        got_rows = back[owner.clamp(max=D - 1), inv.clamp(max=Q - 1)]
        got_rows = torch.where(got[:, None, None], got_rows, 0)  # (N, R, Fa)
        outs = tuple(got_rows[:, 0, i] if R == 1 else got_rows[..., i]
                     for i in range(Fa))
        route_ovf = (~ok & (so < D)).sum()
        self.route_overflow = self.route_overflow + route_ovf
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
            self._ref_owner(q_hi.reshape(-1)), v,
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
            self._snp_owner(q_hi.reshape(-1)), v,
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
        (bs,), _ = self._route(self._ref_owner(q),
                               torch.ones_like(q, dtype=torch.bool), (q,),
                               ans)
        return bs.reshape(shp)

    # --- routed block scans ---

    def _scan(self, is_ref: bool, q_hi, q_lo, active) -> ScanResult:
        R = self.scan_slots
        owner = self._ref_owner(q_hi) if is_ref else self._snp_owner(q_hi)
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

        outs, route_ovf = self._route(owner, active, (q_hi, q_lo, active),
                                      ans, R=R)
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
