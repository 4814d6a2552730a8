"""The batched genotyping step (port of ``vargeno_tpu/engine/batch.py``
orientation_pass, pileup_accumulate, step_single_enc and the dual-orientation
step / step_enc).

The reference's per-read sequential loop (src/qv.cc:760-1558) becomes a
fixed-shape data-parallel pipeline over B reads x K k-mers:

  exact lookups -> low-quality k-mer compaction -> neighbor probe grid ->
  probe-hit compaction -> aux/event expansion into an ordered (B, E) event
  buffer -> vote scan (hand-written CUDA kernel on the card) -> agreeing-
  context compaction -> pileup scatter.

Event ORDER inside a read reproduces the reference exactly (the vote state
machine, qv.cc:132-178, is order-sensitive): per k-mer, the exact ref
hit(s), the exact snp hit(s), then the quality-gated neighbor events in
probe-grid column order.

Every capacity is fixed per config; overflow counters report truncation so
the runner can double the tripped capacity and redo the batch.

Every operation a step launches falls inside exactly one innermost span
(``utils.profiling.span``, on the profiler's timeline while one runs):
``step.encode`` (the device encode of the codes path and of the dual
step's reverse pass), ``step.lookup`` (the exact lookups in both
dictionaries), ``step.probes`` (neighbour work items, probes, hit
compaction and expansion), ``step.records`` (the ambiguous-hit aux
expansion, then the event counts, offsets, scatters and side table: two
spans a pass), ``step.vote``, ``step.pileup`` and ``step.pack`` (a group's
stacks split, the stats and masks packed into the step's vector). A
routed backend's query and answer exchange is ``step.route``, nested in
the span that queries it.

Conventions: 32-bit words are int64 tensors holding the unsigned value;
index tables are int32 bit patterns (``core.hashes.widen`` on gather). JAX's
clamped gathers are clamped here explicitly, and its dropped scatter
updates go to a sink slot that is cut off afterwards.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import GenoConfig, NO_MODIFICATION, POS_AMBIGUOUS
from ..core.hashes import M32, hash32, popcount, snp_bf_bit, widen
from ..core.kmer import encode_batch, rc_enc
from ..kernels.vote import NB_FLAG, VALID_FLAG, vote_scan_records
from ..utils.profiling import span
from .backend import LocalBackend
from .device_index import TorchDeviceIndex
from .scan_ops import compact_src, cumsum_mask

_I64 = torch.int64

# stats of the port's step that the JAX package's step lacks: it drops the
# spill of its ambiguous-exact compaction without a counter
PORT_ONLY_STATS = ("amb_overflow", "amb_hits")


@dataclasses.dataclass
class _Shapes:
    B: int
    K: int
    E: int
    C: int
    NI: int   # neighbor work items
    H: int    # compacted probe hits per item (x/8)
    A: int    # agreeing contexts per read
    SC: int   # extracted site slots per pileup context


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with JAX's clip semantics, widened to int64 words."""
    return widen(table[idx.clamp(0, table.shape[0] - 1)])


def _bitmap_test(bitmap: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Test bit ``pos`` of an LSB-first 32-bit-word bitmap; positions past
    the end read as 0."""
    word = pos >> 5
    nb = bitmap.shape[0]
    w = widen(bitmap[word.clamp(max=nb - 1)])
    return (word < nb) & (((w >> (pos & 31)) & 1) != 0)


def _get_base(hi, lo, i):
    use_hi = i >= 16
    sh = torch.where(use_hi, 2 * (i - 16), 2 * i)
    return (torch.where(use_hi, hi, lo) >> sh) & 3


def _pack_meta(is_ref, diff, flag, info):
    """bit0 is_ref | bits1-6 diff | bits8-15 flag | bits16-23 info."""
    return is_ref.long() | (diff << 1) | (flag << 8) | (info << 16)


class BatchProcessor:
    """The per-batch step for one config. ``single_enc`` runs one
    orientation and ``dual_enc`` both, from pre-encoded (hi, lo) k-mer
    words; ``dual`` encodes base codes on the device first. ``vote`` is the
    vote implementation, called as ``vote_scan_records`` is (the kernel
    wrapper by default). ``backend_factory(dix)`` makes the step's query
    backend (``LocalBackend`` over the whole index by default; a shard of
    the sharded dictionary hands in its routed backend)."""

    def __init__(self, dix: TorchDeviceIndex, config: GenoConfig,
                 vote=vote_scan_records, backend_factory=None):
        cfg = self.cfg = config
        self.dix = dix
        self.vote = vote
        if backend_factory is None:
            def backend_factory(dix_t):
                return LocalBackend(dix_t, cfg.replicate_stride_bug,
                                    cfg.block_size_threshold,
                                    cfg.scan_slot_cap, cfg.probe_active_frac,
                                    cfg.scan_active_frac)
        self.backend_factory = backend_factory
        self.shapes = _Shapes(
            B=cfg.batch_reads, K=cfg.max_kmers_per_read,
            E=cfg.events_per_read, C=cfg.candidates_per_read,
            NI=max(8, int(cfg.batch_reads * cfg.max_kmers_per_read
                          * cfg.neighbor_item_frac)),
            H=cfg.probe_hit_cap, A=cfg.agree_cap,
            SC=min(cfg.sites_per_context, 32))
        be0 = self._backend()
        self.P_SMALL = be0.ref_scan_slots + be0.snp_scan_slots
        # no ref hi32 block reaches the big-block threshold: the big-block
        # lo-half enumeration (qv.cc:962-1108) is dead, drop its columns
        self.NO_BIG = dix.ref_scan_max < cfg.block_size_threshold
        self.P2 = self.P_SMALL + (0 if self.NO_BIG else 128) + 128

    def _backend(self):
        return self.backend_factory(self.dix)

    # ------------------------------------------------------------------
    def neighbor_probes(self, be, it_hi, it_lo, it_valid):
        """All neighbor probes of the NI work items -> hit mask (NI, P2)
        and packed rows (NI, P2, 4) [pos, nb_hi, nb_lo, meta]. Column order
        (= within-item event order) matches the reference: small ref scan,
        small snp scan, interleaved big-lo ref/snp, interleaved hi ref/snp.
        """
        dix = self.dix
        NI = it_hi.shape[0]
        dev = it_hi.device
        if self.NO_BIG:
            big = torch.zeros(NI, dtype=torch.bool, device=dev)
        else:
            big = be.ref_block_size(it_hi) >= self.cfg.block_size_threshold

        # Bloom-filter pruning (qv.cc:946-956)
        ref_bit = hash32(it_lo)
        if dix.ref_bf_bits < (1 << 32):  # identity at reference geometry
            ref_bit = ref_bit % dix.ref_bf_bits
        ref_hit_bf = _bitmap_test(dix.ref_bf, ref_bit)
        snp_hit_bf = _bitmap_test(
            dix.snp_bf, snp_bf_bit(it_hi & 0xFF, it_lo, dix.snp_bf_bits))
        ref_bound = torch.where(ref_hit_bf, 64, 32)
        snp_bound = torch.where(snp_hit_bf, 64, 40)

        def rows_of(pos, nb_hi, nb_lo, meta):
            return torch.stack(torch.broadcast_tensors(pos, nb_hi, nb_lo,
                                                       meta), -1)

        # --- small-block scans (ref then snp) ---
        rs = be.ref_scan(it_hi, it_lo, it_valid & ~big)
        ss = be.snp_scan(it_hi, it_lo, it_valid & ~big)
        scan_overflow = rs.overflow + ss.overflow
        hit_scan = [rs.hit, ss.hit]
        rows_scan = [
            rows_of(rs.pos, rs.nb_hi, rs.nb_lo,
                    _pack_meta(torch.ones_like(rs.hit), rs.diff, rs.flag,
                               rs.info)),
            rows_of(ss.pos, ss.nb_hi, ss.nb_lo,
                    _pack_meta(torch.zeros_like(ss.hit), ss.diff, ss.flag,
                               ss.info))]

        bgrid = torch.arange(16, device=dev).repeat_interleave(4)[None, :]
        jgrid = torch.arange(4, device=dev).repeat(16)[None, :]   # (1, 64)
        bgrid_h = bgrid + 16
        bitpos = 2 * bgrid_h
        sh = 2 * bgrid
        cur_h = (it_hi[:, None] >> sh) & 3
        base_ok = jgrid != cur_h
        nb_hi_h = (it_hi[:, None] & ~(3 << sh)) | (jgrid << sh)
        nb_lo_h = it_lo[:, None].expand(NI, 64)
        act_ref = (it_valid[:, None] & base_ok
                   & (bitpos < ref_bound[:, None]))
        act_snp = (it_valid[:, None] & base_ok
                   & (big[:, None] | (bitpos >= 40))
                   & (bitpos < snp_bound[:, None]))

        if self.NO_BIG:
            q_hi_all, q_lo_all = nb_hi_h, nb_lo_h
            act_ref_all, act_snp_all = act_ref, act_snp
            diff_all = bgrid_h.expand(NI, 64)
        else:
            # big-block lo-half enumeration (qv.cc:965-1108) ahead of the
            # hi-half probes, answered by one lookup over both grids
            cur = (it_lo[:, None] >> sh) & 3
            act_bl = it_valid[:, None] & big[:, None] & (jgrid != cur)
            nb_lo_big = (it_lo[:, None] & ~(3 << sh)) | (jgrid << sh)
            nb_hi_big = it_hi[:, None].expand(NI, 64)
            q_hi_all = torch.cat([nb_hi_big, nb_hi_h], 1)
            q_lo_all = torch.cat([nb_lo_big, nb_lo_h], 1)
            act_ref_all = torch.cat([act_bl, act_ref], 1)
            act_snp_all = torch.cat([act_bl, act_snp], 1)
            diff_all = torch.cat([bgrid.expand(NI, 64),
                                  bgrid_h.expand(NI, 64)], 1)
        if hasattr(be, "exact_both_sparse"):
            (r_hit, r_pos, r_flag, s_hit, s_pos, s_info, s_flag) = \
                be.exact_both_sparse(q_hi_all, q_lo_all, act_ref_all,
                                     act_snp_all)
        else:   # routed backend: one routed lookup per dictionary
            r_hit, r_pos, r_flag = be.exact_ref(q_hi_all, q_lo_all,
                                                act_ref_all)
            s_hit, s_pos, s_info, s_flag = be.exact_snp(q_hi_all, q_lo_all,
                                                        act_snp_all)

        zero = torch.zeros_like(q_hi_all)
        rows_ref = rows_of(r_pos, q_hi_all, q_lo_all,
                           _pack_meta(torch.ones_like(zero), diff_all,
                                      r_flag, zero))
        rows_snp = rows_of(s_pos, q_hi_all, q_lo_all,
                           _pack_meta(zero, diff_all, s_flag, s_info))
        hit_ref = act_ref_all & r_hit
        hit_snp = act_snp_all & s_hit

        def interleave(a_ref, a_snp):
            # (NI, PG[, 4]) pair -> (NI, 2*PG[, 4]) r0,s0,r1,s1,... order
            st = torch.stack([a_ref, a_snp], 2)
            return st.reshape((NI, 2 * a_ref.shape[1]) + a_ref.shape[2:])

        p_hit = torch.cat(hit_scan + [interleave(hit_ref, hit_snp)], 1)
        p_rows = torch.cat(rows_scan + [interleave(rows_ref, rows_snp)], 1)
        return p_hit, p_rows, scan_overflow

    # ------------------------------------------------------------------
    def expand_probe_events(self, p_is_ref, p_pos, p_flag, p_info, p_diff,
                            p_valid):
        """(NH,) compacted probe hits -> (NH, 10) candidate events
        (kmer_pos, validity) + the site-check compaction overflow."""
        dix = self.dix
        dev = p_pos.device
        usable = p_valid & (p_pos != POS_AMBIGUOUS)
        unamb = p_flag == 0

        # aux rows are read only for ambiguous hits; the rest read row 0
        need_aux = usable & ~unamb
        aux_p = torch.where(need_aux, p_pos, 0)
        m_r = dix.n_ref_aux
        m_s = dix.aux_all.shape[0] - m_r
        aux_row = torch.where(p_is_ref, aux_p.clamp(max=m_r - 1),
                              m_r + aux_p.clamp(max=max(m_s - 1, 0)))
        aux_rows = _take(dix.aux_all, aux_row)               # (NH, 10, 2)
        aux_pos = aux_rows[..., 0]
        aux_snp = aux_rows[..., 1]

        col0 = torch.arange(10, device=dev) == 0
        kpos = torch.where(unamb[:, None] & col0, p_pos[:, None], aux_pos)
        col_valid = torch.where(unamb[:, None], col0, aux_pos != 0)

        live = usable[:, None] & col_valid
        # known-SNP-site suppression (qv.cc:985-993), REF events only, on
        # the compacted live lanes; spills count as probe overflow
        NH = live.shape[0]
        NH10 = NH * 10
        site_live = live & p_is_ref[:, None]
        qsrc, qovf = compact_src(site_live.reshape(-1), max(64, 2 * NH))
        q_ok = qsrc >= 0
        qs = qsrc.clamp(min=0)
        kpos_d = ((kpos + p_diff[:, None]) & M32).reshape(-1)
        q_pos = torch.where(q_ok, kpos_d[qs.clamp(max=NH10 - 1)], 0)
        is_site_c = _bitmap_test(dix.site_bitmap, q_pos)
        is_site = torch.zeros(NH10 + 1, dtype=torch.bool, device=dev)
        is_site.index_put_((torch.where(q_ok, qs, NH10),), is_site_c)
        is_site = is_site[:NH10].reshape(NH, 10)
        snp_off = (torch.where(unamb[:, None] & col0, p_info[:, None],
                               aux_snp) >> 3) & 0x1F
        check = torch.where(p_is_ref[:, None], ~is_site,
                            snp_off != p_diff[:, None])
        ev_valid = usable[:, None] & col_valid & check
        return kpos, ev_valid, qovf

    # ------------------------------------------------------------------
    def orientation_pass(self, be, hi, lo, kmer_valid, read_ok, qual):
        sh = self.shapes
        B, K, E, C, NI, H = sh.B, sh.K, sh.E, sh.C, sh.NI, sh.H
        P2 = self.P2
        dix = self.dix
        cfg = self.cfg
        dev = hi.device

        with span("step.lookup"):
            if hasattr(be, "exact_both"):
                (r_hit, r_pos, r_flag, s_hit, s_pos, s_info, s_flag) = \
                    be.exact_both(hi, lo, kmer_valid)
            else:   # routed backend
                r_hit, r_pos, r_flag = be.exact_ref(hi, lo, kmer_valid)
                s_hit, s_pos, s_info, s_flag = be.exact_snp(hi, lo, kmer_valid)
            r_hit = r_hit & kmer_valid
            s_hit = s_hit & kmer_valid

        with span("step.records"):
            # exact hits: the common unambiguous case writes one event
            # directly; the rare ambiguous case is compacted across the batch
            # before its 10-wide aux expansion
            r_usable = r_hit & (r_pos != POS_AMBIGUOUS)
            s_usable = s_hit & (s_pos != POS_AMBIGUOUS)
            r_un_v = r_usable & (r_flag == 0)
            s_un_v = s_usable & (s_flag == 0)
            r_am_v = r_usable & (r_flag != 0)
            s_am_v = s_usable & (s_flag != 0)

            NA = max(64, int(B * cfg.amb_hits_per_read))
            # (b, k, d) order
            am_mask = torch.stack([r_am_v, s_am_v], -1).reshape(-1)
            na_src, amb_overflow = compact_src(am_mask, NA)
            na_ok = na_src >= 0
            na_s = na_src.clamp(min=0)
            na_b = na_s // (K * 2)
            na_k = (na_s // 2) % K
            na_isref = (na_s % 2) == 0
            na_auxrow = torch.where(na_isref, r_pos[na_b, na_k],
                                    s_pos[na_b, na_k])
            m_r = dix.n_ref_aux
            m_s = dix.aux_all.shape[0] - m_r
            na_row = torch.where(na_isref, na_auxrow.clamp(max=m_r - 1),
                                 m_r + na_auxrow.clamp(max=max(m_s - 1, 0)))
            na_aux = _take(dix.aux_all, na_row)[..., 0]          # (NA, 10)
            na_colv = na_ok[:, None] & (na_aux != 0)
            na_count = na_colv.sum(-1)

            # per-(B, K) exact event counts
            am_cnt = torch.zeros(B * K * 2 + 1, dtype=_I64, device=dev)
            am_cnt.index_put_(
                (torch.where(na_ok, na_s, B * K * 2),), na_count)
            am_cnt = am_cnt[:B * K * 2].reshape(B, K, 2)
            exr_n = r_un_v.long() + am_cnt[..., 0]
            exs_n = s_un_v.long() + am_cnt[..., 1]

        with span("step.probes"):
            # ---- neighbor work-item compaction ----
            lowq = kmer_valid & (qual < cfg.quality_score)
            item_src, ni_overflow = compact_src(lowq.reshape(-1), NI)
            it_ok = item_src >= 0
            it_b = torch.where(it_ok, item_src // K, 0)
            it_k = torch.where(it_ok, item_src % K, 0)
            it_hi = hi[it_b, it_k]
            it_lo = lo[it_b, it_k]

            p_hit, p_rows, scan_ovf = self.neighbor_probes(be, it_hi, it_lo,
                                                           it_ok)

            # ---- flat probe-hit compaction (NI, P2) -> (NH,) ----
            NH = max(64, NI * H // 8)
            ph_src, ph_overflow = compact_src(p_hit.reshape(-1), NH)
            h_ok = ph_src >= 0
            h_s = ph_src.clamp(min=0)
            h_item = h_s // P2
            h_rows = torch.where(h_ok[:, None],
                                 p_rows.reshape(NI * P2, 4)[h_s], 0)
            h_pos, h_nbhi, h_nblo, h_meta = h_rows.unbind(1)
            h_isref = (h_meta & 1) != 0
            h_diff = (h_meta >> 1) & 0x3F
            h_flag = (h_meta >> 8) & 0xFF
            h_info = (h_meta >> 16) & 0xFF
            h_b = it_b[h_item]
            h_k = it_k[h_item]

            nb_kpos, nb_valid, site_q_ovf = self.expand_probe_events(
                h_isref, h_pos, h_flag, h_info, h_diff, h_ok)    # (NH, 10)
            ph_overflow = ph_overflow + site_q_ovf

        with span("step.records"):
            # ---- event counts and group offsets ----
            nb_cnt = nb_valid.sum(-1)                             # (NH,)
            nb_n_item = torch.zeros(NI, dtype=_I64, device=dev).index_add_(
                0, h_item, torch.where(h_ok, nb_cnt, 0))
            nb_n_flat = torch.zeros(B * K + 1, dtype=_I64, device=dev)
            nb_n_flat.index_put_((torch.where(it_ok, item_src, B * K),),
                                 nb_n_item)
            nb_n = nb_n_flat[:B * K].reshape(B, K)
            groups = torch.stack([exr_n, exs_n, nb_n], -1).reshape(B, 3 * K)
            goff = torch.cumsum(groups, -1) - groups
            ev_total = groups.sum(-1)
            ev_overflow = (ev_total - E).clamp(min=0).sum()
            h_n = h_ok.sum()
            tune_stats = dict(ev_max=ev_total.max(), lowq_n=lowq.sum(),
                              probe_hits=h_n, probe_lanes_max=h_n,
                              amb_hits=am_mask.sum())

            # Event records are two words [idx, meta] with
            # meta = k | isnb<<5 | valid<<6 | src<<7, scattered into
            # (B*(E+1),) word buffers (slot E of each read is padding; NEV is
            # the sink). The pileup re-derives kmer words and the mutated base
            # from `meta` through the side table `kt`.
            NEV = B * (E + 1)
            ev_idx_f = torch.zeros(NEV + 1, dtype=_I64, device=dev)
            ev_meta_f = torch.zeros(NEV + 1, dtype=_I64, device=dev)

            # exact unambiguous: one event at its group's base slot
            kslot = torch.arange(K, device=dev)[None, :].expand(B, K)
            g_exr = goff[:, 0::3]
            g_exs = goff[:, 1::3]
            base2 = torch.arange(B, device=dev)[:, None] * (E + 1)
            t_r = torch.where(r_un_v & (g_exr < E), base2 + g_exr, NEV)
            t_s = torch.where(s_un_v & (g_exs < E), base2 + g_exs, NEV)
            t_rs = torch.cat([t_r, t_s], 1).reshape(-1)
            i_rs = (torch.cat([r_pos - kslot * 32, s_pos - kslot * 32], 1)
                    & M32).reshape(-1)
            m_ex = kslot | VALID_FLAG
            m_rs = torch.cat([m_ex, m_ex], 1).reshape(-1)
            ev_idx_f.index_put_((t_rs,), i_rs)
            ev_meta_f.index_put_((t_rs,), m_rs)

            # exact ambiguous: compact the aux events, then scatter
            na_g = goff[na_b, 3 * na_k + torch.where(na_isref, 0, 1)]
            na_rank = torch.cumsum(na_colv, -1) - 1
            e_a = na_g[:, None] + na_rank
            t_a = torch.where(na_colv & (e_a < E),
                              na_b[:, None] * (E + 1) + e_a, NEV)
            NAX = max(64, 4 * NA)   # spills count into amb_overflow
            i_a = (na_aux - na_k[:, None] * 32) & M32
            m_a = (na_k[:, None] | VALID_FLAG).expand_as(i_a)
            fa_rows = torch.stack([i_a.reshape(-1), m_a.reshape(-1),
                                   t_a.reshape(-1)], 1)
            ax_src, ax_ovf = compact_src((t_a < NEV).reshape(-1), NAX)
            amb_overflow = amb_overflow + ax_ovf
            ax_ok = ax_src >= 0
            ax_rows = torch.where(ax_ok[:, None], fa_rows[ax_src.clamp(min=0)],
                                  0)
            ax_t = torch.where(ax_ok, ax_rows[:, 2], NEV)
            ev_idx_f.index_put_((ax_t,), ax_rows[:, 0])
            ev_meta_f.index_put_((ax_t,), ax_rows[:, 1])

            # neighbor events: (NH, 10); order within an item = (probe, col);
            # within-item base = global exclusive cumsum minus the item's start
            C_ex = cumsum_mask(nb_cnt) - nb_cnt
            item_base = cumsum_mask(nb_n_item) - nb_n_item
            within = C_ex - item_base[h_item]
            nb_g = goff[h_b, 3 * h_k + 2]
            col_rank = torch.cumsum(nb_valid, -1) - 1
            e_nb = (nb_g + within)[:, None] + col_rank
            e_nb = torch.where(nb_valid & (e_nb < E), e_nb, E + 1)

            # compact the sparse neighbor events; their wide fields (kmer
            # words, mutated base) go to the side table, only the 2-word
            # records are scattered
            NSE = max(64, int(B * (E + 1) * cfg.sparse_events_frac))
            f_e = e_nb.reshape(-1)
            f_t = torch.where(e_nb < E, h_b[:, None] * (E + 1) + e_nb,
                              NEV).reshape(-1)

            def per_col(x):
                return x[:, None].expand(NH, 10).reshape(-1)

            f_w6 = torch.stack([nb_kpos.reshape(-1), per_col(h_k),
                                per_col(h_nbhi), per_col(h_nblo),
                                per_col(h_diff), f_t], 1)
            se_src, sev_overflow = compact_src(f_e < E, NSE)
            se_ok = se_src >= 0
            se_rows = torch.where(se_ok[:, None], f_w6[se_src.clamp(min=0)], 0)
            se_t = torch.where(se_ok, se_rows[:, 5], NEV)
            se_k = se_rows[:, 1]
            ev_idx_f.index_put_((se_t,), (se_rows[:, 0] - se_k * 32) & M32)
            ev_meta_f.index_put_(
                (se_t,), (se_k | NB_FLAG | VALID_FLAG
                          | (torch.arange(NSE, device=dev) << 7)) & M32)

            # unified pileup source table: row b*K+k = the read kmer at slot k
            # (no mutation); row B*K+j = compacted neighbor row j's mutated
            # kmer + mutated-base index
            kt = torch.cat([
                torch.stack([hi.reshape(-1), lo.reshape(-1),
                             torch.full((B * K,), NO_MODIFICATION,
                                        dtype=_I64, device=dev)], -1),
                torch.stack([se_rows[:, 2], se_rows[:, 3],
                             torch.where(se_ok, se_rows[:, 4],
                                         NO_MODIFICATION)], -1)], 0)

            # the vote and the pileup read the records in place: (B, E) views
            # of the (B, E + 1)-strided word buffers
            ev_idx = ev_idx_f[:NEV].reshape(B, E + 1)[:, :E]
            meta = ev_meta_f[:NEV].reshape(B, E + 1)[:, :E]
            buf = dict(idx=ev_idx, meta=meta, valid=(meta & VALID_FLAG) != 0,
                       kt=kt)

        # ---- vote scan (improved_index_table_add, qv.cc:132-178) ----
        with span("step.vote"):
            process, target, cand_ovf = self.vote(ev_idx, meta, ev_total, C)
        stats = dict(ni_overflow=ni_overflow, probe_overflow=ph_overflow,
                     event_overflow=ev_overflow, sev_overflow=sev_overflow,
                     amb_overflow=amb_overflow,
                     cand_overflow=cand_ovf, snp_scan_overflow=scan_ovf,
                     **tune_stats)
        return dict(buf=buf, process=process, target=target,
                    read_ok=read_ok, stats=stats)

    # ------------------------------------------------------------------
    def pileup_accumulate(self, buf, use_mask, target, ref_cnt, alt_cnt):
        """Scatter agreeing contexts into per-site counts
        (qv.cc:1382-1502). Agreeing contexts are compacted across the whole
        batch into FA = B * agree_cap slots; counts are order-independent
        sums, so batch-flat processing is exact. Returns new count tensors
        (the inputs are left untouched: the runner rewinds to them when a
        batch is redone)."""
        sh = self.shapes
        B, E, K = sh.B, sh.E, sh.K
        dix = self.dix
        dev = target.device
        FA = max(64, B * sh.A)
        n_sites = dix.n_sites
        nwords = dix.site_dir.shape[0]

        agree = (buf["valid"] & use_mask[:, None]
                 & (buf["idx"] == target[:, None])).reshape(-1)
        agree_n = agree.sum()
        src_idx, agree_ovf = compact_src(agree, FA)
        f_ok = src_idx >= 0
        s = src_idx.clamp(min=0)
        a_idx = torch.where(f_ok, buf["idx"].reshape(-1)[s], 0)
        a_meta = torch.where(f_ok, buf["meta"].reshape(-1)[s], 0)
        a_k = a_meta & 0x1F
        a_isnb = f_ok & ((a_meta & (1 << 5)) != 0)
        a_src = a_meta >> 7
        a_b = s // E
        a_kpos = (a_idx + a_k * 32) & M32
        kt = buf["kt"]
        kt_row = torch.where(a_isnb, B * K + a_src, a_b * K + a_k)
        ktr = torch.where(f_ok[:, None],
                          kt[kt_row.clamp(0, kt.shape[0] - 1)], 0)
        a_nbhi = ktr[:, 0]
        a_nblo = ktr[:, 1]
        a_modif = torch.where(f_ok, ktr[:, 2], NO_MODIFICATION)

        # a context covers 32 consecutive genome positions: its site
        # membership lives in two bitmap words, fetched with their ranks
        w0 = a_kpos >> 5
        off = a_kpos & 31
        d = _take(dix.site_dir, w0.clamp(max=nwords - 1))     # (FA, 4)
        bm0, rk0, bm1, rk1 = d.unbind(1)
        bm0 = torch.where(w0 < nwords, bm0, 0)
        bm1 = torch.where(w0 + 1 < nwords, bm1, 0)

        # the context's 32-base site mask; sites are extracted by repeated
        # lowest-set-bit clearing into SC slots per context
        m = torch.where(f_ok, (bm0 >> off)
                        | torch.where(off > 0, (bm1 << (32 - off)) & M32, 0),
                        0)
        # exclude the mutated base (qv.cc:1470: skip modified_pos)
        m = m & ~torch.where(a_modif < 32, 1 << a_modif.clamp(0, 31), 0)

        S = sh.SC
        e_i = []
        e_ok = []
        mm = m
        for _ in range(S):
            lb = mm & -mm                        # lowest set bit
            e_ok.append(lb != 0)
            e_i.append(popcount((lb - 1) & M32))
            mm = mm & (mm - 1)                   # clear it
        slot_ovf = popcount(mm).sum()
        x_i = torch.stack(e_i, 1)                # (FA, S) base index
        x_ok = torch.stack(e_ok, 1)

        # site id = rank directory + popcount of the word's lower bits
        oi = off[:, None] + x_i
        in_w1 = oi >= 32
        bit = oi & 31
        bm = torch.where(in_w1, bm1[:, None], bm0[:, None])
        rk = torch.where(in_w1, rk1[:, None], rk0[:, None])
        src = rk + popcount(bm & ((1 << bit) - 1))
        src = src.clamp(max=max(n_sites - 1, 0))

        # flat compaction of extracted hits, then one gather + scatter-add
        FG = FA // 2
        gs, site_ovf = compact_src(x_ok.reshape(-1), FG)
        g_ok = gs >= 0
        g = gs.clamp(min=0)
        g_src = torch.where(g_ok, src.reshape(-1)[g], 0)
        g_ctx = g // S
        g_i = x_i.reshape(-1)[g]
        g_base = _get_base(a_nbhi[g_ctx], a_nblo[g_ctx], g_i)

        ra = _take(dix.site_ra, g_src)
        sref = ra & 0xFF
        salt = (ra >> 8) & 0xFF
        add_ref = g_ok & (g_base == sref)
        add_alt = g_ok & ~add_ref & (g_base == salt)
        tgt_row = torch.where(g_ok, g_src, n_sites)           # dump row
        ref_cnt = ref_cnt.index_add(0, tgt_row, add_ref.to(ref_cnt.dtype))
        alt_cnt = alt_cnt.index_add(0, tgt_row, add_alt.to(alt_cnt.dtype))
        return ref_cnt, alt_cnt, agree_ovf + site_ovf, slot_ovf, agree_n

    # ------------------------------------------------------------------
    def single_enc(self, hi, lo, kvalid, read_ok, qual, ref_cnt, alt_cnt):
        """One orientation from host-pre-encoded k-mer words: pileup for
        processed reads, and (process, read_ok) so the host can queue
        reverse-complement retries (qv.cc:1504-1510).

        hi/lo (B, K) int64 words, kvalid (B, K) bool, read_ok (B,) bool,
        qual (B, K) uint8; ref_cnt/alt_cnt (n_sites + 1,) int32.
        Returns (ref_cnt, alt_cnt, process, read_ok, stats)."""
        be = self._backend()
        res = self.orientation_pass(be, hi, lo, kvalid, read_ok, qual)
        with span("step.pileup"):
            ref_cnt, alt_cnt, aovf, sovf, agree_n = self.pileup_accumulate(
                res["buf"], res["process"], res["target"], ref_cnt, alt_cnt)
        stats = dict(res["stats"])
        stats["agree_overflow"] = aovf
        stats["site_slot_overflow"] = sovf
        stats["agree_lanes_max"] = agree_n
        with span("step.pack"):
            stats["n_processed"] = res["process"].sum()
            # reads this orientation failed that are retry-eligible
            stats["retry_n"] = (~res["process"] & res["read_ok"]
                                & kvalid[:, 0]).sum()
        _backend_stats(be, stats)
        return ref_cnt, alt_cnt, res["process"], res["read_ok"], stats

    def single(self, codes, n_kmers, qual, ref_cnt, alt_cnt):
        """``single_enc`` from (B, L) uint8 base codes, encoded on the
        device (the runner's codes path, ``pre_encode=False``)."""
        with span("step.encode"):
            enc = encode_batch(codes, n_kmers, self.shapes.K)
        return self.single_enc(*enc, qual, ref_cnt, alt_cnt)

    def multi_enc(self, hi, lo, kvalid, read_ok, qual, ref_cnt, alt_cnt):
        """Grouped dispatch: G pre-encoded sub-batches, (G, B, ...) stacks,
        issued back to back as G ``single_enc`` steps on one stream with
        the counts chained through them, so they add up as G sequential
        steps would. Stats reduce over the group (``*_max`` keys take the
        max, the rest the sum); the masks come back as (G, B). The input
        accumulators are left untouched (a redo rewinds to them).
        Returns (ref_cnt, alt_cnt, process, read_ok, stats)."""
        procs, oks, rows = [], [], []
        with span("step.pack"):   # the stacks split into sub-batches
            subs = list(zip(*(t.unbind(0)
                              for t in (hi, lo, kvalid, read_ok, qual))))
        for sub in subs:
            ref_cnt, alt_cnt, process, rok, stats = self.single_enc(
                *sub, ref_cnt, alt_cnt)
            procs.append(process)
            oks.append(rok)
            rows.append(stats)
        stats = {}
        with span("step.pack"):
            for k in rows[0]:
                col = torch.stack([torch.as_tensor(r[k]) for r in rows])
                stats[k] = col.max() if k.endswith("_max") else col.sum()
            procs, oks = torch.stack(procs), torch.stack(oks)
        return ref_cnt, alt_cnt, procs, oks, stats

    # ------------------------------------------------------------------
    def dual_enc(self, hi, lo, kvalid, read_ok, n_kmers, qual, ref_cnt,
                 alt_cnt):
        """Both orientations in one step, from pre-encoded k-mer words: the
        forward pass, the reverse-complement pass derived from the packed
        words (``core.kmer.rc_enc``), and a pileup for each -- forward for
        the reads it processed, reverse for the reads only the reverse pass
        processed (qv.cc:1504-1510). n_kmers (B,) is each read's k-mer
        count. Returns (ref_cnt, alt_cnt, stats); per-pass stats carry a
        ``fwd_`` / ``rev_`` prefix."""
        be = self._backend()
        fwd = self.orientation_pass(be, hi, lo, kvalid, read_ok, qual)
        with span("step.encode"):
            rc = rc_enc(hi, lo, kvalid, read_ok, n_kmers, self.shapes.K)
        rev = self.orientation_pass(be, *rc, qual)
        with span("step.pileup"):
            use_fwd = fwd["process"]
            use_rev = ~fwd["process"] & fwd["read_ok"] & rev["process"]
            ref_cnt, alt_cnt, aovf1, sovf1, an1 = self.pileup_accumulate(
                fwd["buf"], use_fwd, fwd["target"], ref_cnt, alt_cnt)
            ref_cnt, alt_cnt, aovf2, sovf2, an2 = self.pileup_accumulate(
                rev["buf"], use_rev, rev["target"], ref_cnt, alt_cnt)
        stats = {"fwd_" + k: v for k, v in fwd["stats"].items()}
        stats.update({"rev_" + k: v for k, v in rev["stats"].items()})
        with span("step.pack"):
            stats["agree_overflow"] = aovf1 + aovf2
            stats["site_slot_overflow"] = sovf1 + sovf2
            stats["agree_lanes_max"] = torch.maximum(an1, an2)
            stats["n_processed"] = (use_fwd | use_rev).sum()
        _backend_stats(be, stats)
        return ref_cnt, alt_cnt, stats

    def dual(self, codes, n_kmers, qual, ref_cnt, alt_cnt):
        """``dual_enc`` from (B, L) uint8 base codes, encoded on the
        device."""
        with span("step.encode"):
            enc = encode_batch(codes, n_kmers, self.shapes.K)
        return self.dual_enc(*enc, n_kmers, qual, ref_cnt, alt_cnt)


def _backend_stats(be, stats: dict) -> None:
    """The backend's capacity counters and its real compacted-lane counts
    (summed / maximized over the step's passes), as the ``*_overflow`` and
    ``*_lanes_max`` stats that escalation and auto-tuning read; each only
    where the backend keeps it (the routed backend keeps route_overflow,
    the local one the rest)."""
    for attr, key in (("route_overflow", "route_overflow"),
                      ("act_overflow", "act_overflow"),
                      ("act_lanes", "act_lanes_max"),
                      ("ref_scan_lanes", "ref_scan_lanes_max"),
                      ("snp_scan_lanes", "snp_scan_lanes_max")):
        v = getattr(be, attr, None)
        if v is not None:
            stats[key] = v


def make_batch_processor(dix: TorchDeviceIndex, config: GenoConfig,
                         vote=vote_scan_records,
                         backend_factory=None) -> BatchProcessor:
    return BatchProcessor(dix, config, vote, backend_factory)
