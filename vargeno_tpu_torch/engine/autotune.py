"""Jax-free copy of ``vargeno_tpu/engine/autotune.py``, without the retired
prefilter's ``sparse_lanes_max`` -> ``sparse_frac`` branch.

Runtime capacity auto-tuning from the engine's own lane telemetry.

Every compacted-lane capacity (events, neighbor items, probe hits, active/
scan lanes) pays full gather cost per SLOT whether the slot is live
or padding, so caps far above the workload's real maxima are pure waste.
After ``tune_batches`` batches the runner shrinks each capacity to the
measured per-batch maximum x ``tune_headroom``; overflow escalation
(engine.geno._escalate_config) restores exactness if a tuned cap ever trips
later, so tuning can never change results.

The reference has no analog: its buffers are unbounded heap structures
(SURVEY §2.1); a fixed-shape step makes capacity a first-class
performance knob.
"""

from __future__ import annotations

import dataclasses
import math

# telemetry keys consumed (per-batch maxima; dual-orientation steps emit
# them with fwd_/rev_ prefixes which the runner strips)
TUNE_KEYS = ("ev_max", "lowq_n", "probe_lanes_max", "act_lanes_max",
             "ref_scan_lanes_max", "snp_scan_lanes_max", "agree_lanes_max")


def _ceil_to(x: float, m: int) -> int:
    return int(-(-int(math.ceil(x)) // m) * m)


def tuned_config(cfg, dix, batch_max: dict, headroom: float = 2.0):
    """Return cfg with lane capacities shrunk toward measured maxima.

    Only ever SHRINKS a capacity (values above current are clamped);
    returns cfg unchanged when nothing shrinks. ``batch_max`` maps
    TUNE_KEYS to the largest per-batch value seen.
    """
    B, K = cfg.batch_reads, cfg.max_kmers_per_read
    upd: dict = {}

    # NI: compacted low-quality kmer items (neighbor search inputs)
    NI_cur = max(8, int(B * K * cfg.neighbor_item_frac))
    lowq = batch_max.get("lowq_n", 0)
    if lowq:
        NI_new = min(NI_cur, max(64, _ceil_to(lowq * headroom, 64)))
        if NI_new < NI_cur:
            upd["neighbor_item_frac"] = NI_new / (B * K)
    NI_t = max(8, int(B * K * upd.get("neighbor_item_frac",
                                      cfg.neighbor_item_frac)))

    # E: per-read event slots
    ev = batch_max.get("ev_max", 0)
    if ev:
        E_new = min(cfg.events_per_read, max(4, _ceil_to(ev * headroom, 4)))
        if E_new < cfg.events_per_read:
            upd["events_per_read"] = E_new

    # NH: compacted neighbor-probe hit lanes = max(64, NI * cap // 8)
    ph = batch_max.get("probe_lanes_max", 0)
    if ph:
        NH_new = max(64, _ceil_to(ph * headroom, 64))
        cap_new = max(1, math.ceil(NH_new * 8 / max(NI_t, 1)))
        if cap_new < cfg.probe_hit_cap:
            upd["probe_hit_cap"] = cap_new

    # NC: active-probe lane fraction of the (NI x probe-grid) key space
    no_big = getattr(dix, "ref_scan_max", 1 << 30) < cfg.block_size_threshold
    PG = 64 if no_big else 128
    N_probe = max(NI_t * PG, 1)
    need = batch_max.get("act_lanes_max", 0)
    if need:
        cap_cur = max(64, int(N_probe * cfg.probe_active_frac))
        cap_new = max(64, _ceil_to(need * headroom, 64))
        if cap_new < cap_cur:
            upd["probe_active_frac"] = cap_new / N_probe

    # CS: compacted block-scan lanes = max(64, int(NI * S * frac)); S
    # mirrors LocalBackend's slot formula exactly (scan_slot_cap AND
    # block_size_threshold clamp the per-dict build-time maxima)
    S_cap = min(cfg.scan_slot_cap, cfg.block_size_threshold)
    S_r = max(1, min(S_cap, getattr(dix, "ref_scan_max", 1)))
    S_s = max(1, min(S_cap, getattr(dix, "snp_scan_max", 1)))
    need_r = batch_max.get("ref_scan_lanes_max", 0)
    need_s = batch_max.get("snp_scan_lanes_max", 0)
    if need_r or need_s:
        f_cur = min(cfg.scan_active_frac, 1.0)
        f_r = max(64, _ceil_to(need_r * headroom, 64)) / (NI_t * S_r)
        f_s = max(64, _ceil_to(need_s * headroom, 64)) / (NI_t * S_s)
        f_new = min(f_cur, max(f_r, f_s))
        if f_new < f_cur:
            upd["scan_active_frac"] = f_new

    # FA: compacted agreeing-context lanes = max(64, B * agree_cap); the
    # pileup stage's site-directory/word gathers all run on FA lanes
    need_a = batch_max.get("agree_lanes_max", 0)
    if need_a:
        cap_new = max(1, math.ceil(need_a * headroom / B))
        if cap_new < cfg.agree_cap:
            upd["agree_cap"] = cap_new

    if not upd:
        return cfg
    return dataclasses.replace(cfg, **upd)
