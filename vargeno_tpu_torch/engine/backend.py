"""Query backend for a device-resident index (port of
``vargeno_tpu/engine/backend.py`` LocalBackend).

The batch step issues four kinds of dictionary probes: exact ref / exact
snp lookups (one combined bucket-table probe answers both), the ref
jumpgate-block Hamming scan and the snp block Hamming scan (reference:
src/qv.cc:194-264, 316-464). The backend answers them with materialized row
fields (pos/flag/snp_info), including the reference's small-block scan
stride bug (entry ``lo + sizeof*(j)`` tested, entry ``lo + j`` reported;
qv.cc:359, 448).

Out-of-range indices: JAX clamps gathers and drops out-of-range scatter
updates, while torch raises. Every gather index here is clamped, and every
scatter that JAX let drop writes to a sink slot past the end instead.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.hashes import as_i32, ctz32, widen
from .device_index import TorchDeviceIndex
from .hashtable import ht_lookup_both
from .scan_ops import compact_src


@dataclasses.dataclass
class ScanResult:
    """Per-(item, slot) block-scan hits, in block order, zero-padded."""

    hit: torch.Tensor       # bool
    pos: torch.Tensor       # dict pos field: position | aux row | AMBIG
    flag: torch.Tensor
    info: torch.Tensor      # snp_info; zeros for ref scans
    nb_hi: torch.Tensor     # neighbor kmer hi (as the reference builds it)
    nb_lo: torch.Tensor     # neighbor kmer lo
    diff: torch.Tensor      # mutated base index
    overflow: torch.Tensor  # 0-d count of truncated hits/slots


class LocalBackend:
    """All dictionaries resident on one device."""

    def __init__(self, dix: TorchDeviceIndex, stride_bug: bool,
                 block_size_threshold: int, scan_slot_cap: int = 100,
                 active_frac: float = 0.25, scan_active_frac: float = 1.0):
        self.dix = dix
        self.stride_bug = stride_bug
        self.S = block_size_threshold
        self.scan_slots = min(scan_slot_cap, block_size_threshold)
        self.scan_active_frac = scan_active_frac
        # no block exceeds the build-time measured maxima, so the scan width
        # shrinks to the data's bound
        self.ref_scan_slots = max(1, min(self.scan_slots, dix.ref_scan_max))
        self.snp_scan_slots = max(1, min(self.scan_slots, dix.snp_scan_max))
        self.active_frac = active_frac
        self._bounds_memo = None
        # capacity counter and per-step lane maxima (telemetry), reported
        # as act_overflow / *_lanes_max stats
        self.act_overflow = None
        self.act_lanes = None
        self.ref_scan_lanes = None
        self.snp_scan_lanes = None

    def exact_both(self, q_hi, q_lo, valid=None):
        """(r_hit, r_pos, r_flag, s_hit, s_pos, s_info, s_flag)"""
        d = self.dix
        return ht_lookup_both(d.both_ht, d.both_ht_nb, d.both_ht_chain,
                              q_hi, q_lo, valid)

    def exact_both_sparse(self, q_hi, q_lo, act_ref, act_snp):
        """Combined lookup over the lanes where either dictionary is probed:
        one compaction to the active lanes, a bucket-row lookup on them, then
        a scatter back to the original lane ids. Hits are masked by the
        per-dictionary activity masks."""
        shp = q_hi.shape
        qh = q_hi.reshape(-1)
        ql = q_lo.reshape(-1)
        v = (act_ref | act_snp).reshape(-1)
        N = qh.shape[0]

        NC = max(64, min(N, int(N * self.active_frac)))
        act_n = v.sum(dtype=torch.int64)
        self.act_lanes = act_n if self.act_lanes is None \
            else torch.maximum(self.act_lanes, act_n)
        src_a, ovf_a = compact_src(v, NC)
        self.act_overflow = ovf_a if self.act_overflow is None \
            else self.act_overflow + ovf_a
        a_ok = src_a >= 0
        sa = src_a.clamp(min=0)
        qh_c = torch.where(a_ok, qh[sa], 0)
        ql_c = torch.where(a_ok, ql[sa], 0)

        res = self.exact_both(qh_c, ql_c, a_ok)
        orig = torch.where(a_ok, sa, N)          # sink N for empty slots

        def back(x):
            out = torch.zeros(N + 1, dtype=x.dtype, device=x.device)
            out.index_put_((orig,), torch.where(a_ok, x, torch.zeros_like(x)))
            return out[:N].reshape(shp)

        r_hit, r_pos, r_flag, s_hit, s_pos, s_info, s_flag = map(back, res)
        return (r_hit & act_ref, r_pos, r_flag, s_hit & act_snp, s_pos,
                s_info, s_flag)

    def _ref_block_bounds(self, q_hi):
        """(start_row, size) of the hi32 jumpgate block. The hi24 jumpgate
        narrows to the [a, b) hi24 block; one aligned ref_win_rows x 32
        window gather over ref_hi resolves the exact hi32 sub-block.
        Memoized on the query tensor: ref_block_size and ref_scan of one
        step ask for the same items."""
        memo = self._bounds_memo
        if memo is not None and memo[0] is q_hi:
            return memo[1]
        d = self.dix
        h24 = q_hi >> 8
        a = d.ref_jg[h24].long()
        b = d.ref_jg[h24 + 1].long()
        g = d.ref_win_rows
        hi2d = d.ref_hi
        R = hi2d.shape[0]
        dev = q_hi.device
        r0 = (a >> 5).clamp(max=R - 1)
        rows = hi2d[(r0[:, None] + torch.arange(g, device=dev)[None, :])
                    .clamp(max=R - 1)]                     # (NI, g, 32)
        win = rows.reshape(q_hi.shape[0], g * 32)
        gidx = (r0 * 32)[:, None] + torch.arange(g * 32, device=dev)[None, :]
        eq = ((gidx >= a[:, None]) & (gidx < b[:, None])
              & (win == as_i32(q_hi)[:, None]))
        size = eq.sum(1)
        first = torch.argmax(eq.to(torch.int32), 1)
        start = torch.where(size > 0, r0 * 32 + first, 0)
        self._bounds_memo = (q_hi, (start, size))
        return start, size

    def _snp_block_bounds(self, q_hi24):
        """snp blocks ARE hi24 blocks: two jumpgate gathers give bounds."""
        d = self.dix
        a = d.snp_jg[q_hi24].long()
        b = d.snp_jg[q_hi24 + 1].long()
        return a, b - a

    def ref_block_size(self, q_hi):
        return self._ref_block_bounds(q_hi)[1]

    # stride-bug read limits (a test index past them reads as 0, the
    # reference's fresh-heap model) and the two columns the scans test; a
    # shard of the sharded dictionary overrides them (its limit is its owned
    # rows plus the real tail rows, its words come from its search keys)
    def _ref_limit(self) -> int:
        return self.dix.n_ref_rows

    def _snp_limit(self) -> int:
        return self.dix.n_snp_rows

    def _ref_lo(self, idx):
        return widen(self.dix.ref_lo[idx])

    def _snp_test(self, idx):
        """(lo, hi & 0xFF) of the snp rows ``idx``."""
        tst = widen(self.dix.snp_test[idx])                 # (CS, 2)
        return tst[:, 0], tst[:, 1]

    def _scan_lanes(self, NI: int, S: int, active, bsize, which: str):
        """Compact the (item, slot) scan grid to its real test lanes
        (j < block size). Returns (ci, cj, cs, c_ok, spill)."""
        j = torch.arange(S, device=bsize.device)[None, :]
        mask = (active[:, None] & (j < bsize[:, None])).reshape(-1)
        CS = max(64, int(NI * S * min(self.scan_active_frac, 1.0)))
        sc_n = mask.sum(dtype=torch.int64)
        attr = which + "_scan_lanes"
        prev = getattr(self, attr)
        setattr(self, attr,
                sc_n if prev is None else torch.maximum(prev, sc_n))
        csrc, spill = compact_src(mask, CS)
        c_ok = csrc >= 0
        cs = csrc.clamp(min=0)
        return cs // S, cs % S, cs, c_ok, spill

    @staticmethod
    def _scan_back(NI: int, S: int, cs, c_ok, c_hit, fields):
        """Scatter compacted per-lane results back to (NI, S) grids; empty
        slots go to sink NI*S."""
        tgt = torch.where(c_ok, cs, NI * S)

        def back(x):
            out = torch.zeros(NI * S + 1, dtype=x.dtype, device=x.device)
            out.index_put_((tgt,), x)
            return out[:NI * S].reshape(NI, S)

        return back(c_hit), [back(torch.where(c_hit, f, 0)) for f in fields]

    def ref_scan(self, q_hi, q_lo, active) -> ScanResult:
        """Small-block ref scan for each item; ``active`` masks items."""
        d = self.dix
        S = self.ref_scan_slots
        NI = q_hi.shape[0]
        n_ref = self._ref_limit()
        blo, bsize = self._ref_block_bounds(q_hi)
        ci, cj, cs, c_ok, spill = self._scan_lanes(NI, S, active, bsize,
                                                   "ref")
        c_blo = blo[ci]
        stride = 9 if self.stride_bug else 1
        tidx = c_blo + stride * cj
        test_lo = torch.where(c_ok & (tidx < n_ref),
                              self._ref_lo(tidx.clamp(max=n_ref - 1)), 0)
        x = q_lo[ci] ^ test_lo
        k2 = ctz32(x) >> 1
        sh2 = (2 * k2).clamp(max=31)
        c_hit = c_ok & (x != 0) & ((x >> sh2) <= 3)
        mr = (c_blo + cj).clamp(max=d.ref_meta.shape[0] - 1)
        meta = widen(d.ref_meta[mr])                       # (CS, 2)
        hit, (pos, flag, nb_lo, diff) = self._scan_back(
            NI, S, cs, c_ok, c_hit,
            [meta[:, 0], meta[:, 1] & 0xFF, test_lo, k2])
        over = (torch.where(active & (bsize < self.S), bsize, 0) - S)
        return ScanResult(
            hit=hit, pos=pos, flag=flag, info=torch.zeros_like(pos),
            nb_hi=q_hi[:, None].expand(NI, S), nb_lo=nb_lo, diff=diff,
            overflow=spill + over.clamp(min=0).sum())

    def snp_scan(self, q_hi, q_lo, active) -> ScanResult:
        d = self.dix
        S = self.snp_scan_slots
        NI = q_hi.shape[0]
        n_snp = self._snp_limit()
        slo, ssize = self._snp_block_bounds(q_hi >> 8)
        ci, cj, cs, c_ok, spill = self._scan_lanes(NI, S, active, ssize,
                                                   "snp")
        c_slo = slo[ci]
        stride = 11 if self.stride_bug else 1
        tidx = c_slo + stride * cj
        in_dict = c_ok & (tidx < n_snp)
        t_lo, t_hi8 = self._snp_test(tidx.clamp(max=n_snp - 1))
        e_lo = torch.where(in_dict, t_lo, 0)
        e_hi8 = torch.where(in_dict, t_hi8, 0)
        c_qhi = q_hi[ci]
        xlo = q_lo[ci] ^ e_lo
        xhi8 = (c_qhi & 0xFF) ^ e_hi8
        tz40 = torch.where(xlo != 0, ctz32(xlo), 32 + ctz32(xhi8))
        k2s = tz40 >> 1
        sh_lo = (2 * k2s).clamp(0, 31)
        sh_hi = (2 * k2s - 32).clamp(0, 31)
        ok_lo = (xhi8 == 0) & ((xlo >> sh_lo) <= 3)
        ok_hi = (xlo == 0) & ((xhi8 >> sh_hi) <= 3)
        c_hit = (c_ok & torch.where(tz40 < 32, ok_lo, ok_hi)
                 & ((xlo | xhi8) != 0))
        mr = (c_slo + cj).clamp(max=d.snp_meta.shape[0] - 1)
        meta = widen(d.snp_meta[mr])                        # (CS, 2)
        hit, (pos, flag, info, nb_hi, nb_lo, diff) = self._scan_back(
            NI, S, cs, c_ok, c_hit,
            [meta[:, 0], meta[:, 1] & 0xFF, (meta[:, 1] >> 8) & 0xFF,
             (c_qhi & 0xFFFFFF00) | e_hi8, e_lo, k2s])
        over = (torch.where(active & (ssize < 0x10000), ssize, 0) - S)
        return ScanResult(
            hit=hit, pos=pos, flag=flag, info=info,
            nb_hi=nb_hi, nb_lo=nb_lo, diff=diff,
            overflow=spill + over.clamp(min=0).sum())
