"""Roofline accounting for the genotyping inner loop (port of
``vargeno_tpu/utils/roofline.py``).

Two bounds are computed for an engine configuration:

1. ``bytes`` bound -- the step's modelled memory traffic over the device's
   peak memory rate.
2. ``lane`` bound -- the step's gather / scatter / sort lane counts divided
   into per-lane rates MEASURED on the device by
   ``python -m vargeno_tpu_torch.tools.bench_gather``. No rate is built in:
   without a measured dict the report carries ``null`` for the lane bound.

Reference for the semantics being accounted: the reference's hot loop is
the same algorithm as pointer chases (src/qv.cc:834-1367) on one core.
"""

from __future__ import annotations

import dataclasses


# peak memory GB/s by device-name substring (bytes bound only)
DEVICE_HBM_GBPS = {
    "H100": 3350.0,
    "cpu": 50.0,
}


def device_hbm_gbps(device_kind: str) -> float:
    """Peak memory GB/s of a device kind in the table. An unknown kind
    raises: a share of some other device's rate would mean nothing."""
    for k, v in DEVICE_HBM_GBPS.items():
        if k.lower() in device_kind.lower():
            return v
    raise ValueError(f"no peak memory rate known for device kind "
                     f"{device_kind!r}; add it to DEVICE_HBM_GBPS")


def device_lane_rates(measured: dict | None = None):
    """word/row128/row512/scalar/sort lanes per second from a bench_gather
    result dict; None when none is given or a needed rate is missing (the
    bench reports an implausible rate as null)."""
    if not measured:
        return None
    rates = dict(
        word=(measured.get("word_gather_1048576")
              or measured.get("word_gather_2097152")),
        row128=(measured.get("row_gather_1048576")
                or measured.get("row_gather_2097152")),
        row512=measured.get("row_gather_512B"),
        scalar=measured.get("scatter_scalar"),
        sort=measured.get("device_sort_u32"))
    if not all(rates.values()):
        return None
    return rates


@dataclasses.dataclass
class StepTraffic:
    """Per-single-orientation-step traffic model. Each term mirrors one
    gather/scatter/sort family in engine/batch.py; `lowq_frac` comes from
    the engine's own telemetry so the model tracks the actual workload.

    Row lanes are split by width family (128 B window / aux rows, 512 B
    bucket rows) because their per-row rates differ. Narrow-row gathers
    (8-16 B rows: packed meta pairs, scan tests) are counted in
    ``word_lanes``."""

    bytes_total: float
    word_lanes: float
    row128_lanes: float    # 128 B rows (window/aux gathers)
    row512_lanes: float    # 512 B bucket rows (exact probes)
    scalar_lanes: float    # scalar-element scatter source lanes
    sort_keys: float       # u32 keys through sort-based compactions
    detail: dict


def step_traffic(cfg, dix, B: int, lowq_frac: float = 0.05) -> StepTraffic:
    K = cfg.max_kmers_per_read
    chain = dix.both_ht_chain
    row_b = dix.both_ht.shape[1] * 4
    NI = max(8, int(B * K * cfg.neighbor_item_frac))
    NH = max(64, NI * cfg.probe_hit_cap // 8)
    E = cfg.events_per_read
    FA = max(64, B * cfg.agree_cap)
    no_big = dix.ref_scan_max < cfg.block_size_threshold
    PG = 64 if no_big else 128       # neighbor key grid columns
    NC = max(64, int(NI * PG * cfg.probe_active_frac))
    scan_r = min(cfg.scan_slot_cap, getattr(dix, "ref_scan_max", 100))
    scan_s = min(cfg.scan_slot_cap, getattr(dix, "snp_scan_max", 100))
    # scan-stage gathers run on the COMPACTED test-lane grids (backend.
    # _scan_lanes), not the full (NI, S) grids
    CS_r = max(64, int(NI * scan_r * min(cfg.scan_active_frac, 1.0)))
    CS_s = max(64, int(NI * scan_s * min(cfg.scan_active_frac, 1.0)))
    NA = max(64, int(B * cfg.amb_hits_per_read))
    NAX = max(64, 4 * NA)
    NSE = max(64, int(B * (E + 1) * cfg.sparse_events_frac))

    # (word_lanes, row128_lanes, row512_lanes, scalar_lanes, sort_keys,
    #  bytes)
    d = {}
    d["exact"] = (0, 0, B * K * chain, 0, 0, B * K * chain * row_b)
    d["bounds"] = (NI * 2, NI * dix.ref_win_rows, 0, 0, 0,
                   NI * (8 + dix.ref_win_rows * 128))
    d["bf"] = (NI * 2, 0, 0, 0, 0, NI * 8)
    # per compacted test lane: ref scan = ref_lo word + meta 8 B row;
    # snp scan = snp_test 8 B row + meta 8 B row
    d["scan"] = (CS_r * 2 + CS_s * 2, 0, 0, 0, 0, CS_r * 12 + CS_s * 16)
    # probe stage: key-pair row gather on NC compacted lanes, direct
    # bucket lookup (512 B rows), 3-word scalar scatter-back
    d["probe"] = (NC, 0, NC * chain, 3 * NC, 0,
                  NC * 8 + NC * chain * row_b)
    d["aux"] = (0, NH, 0, 0, 0, NH * 80)
    # events: ref+snp exact scatter densely (B*2K); aux + neighbor events
    # are compacted first; every record is 2 scalar word scatters
    d["events"] = (0, NAX + NSE, 0, 2 * (B * 2 * K + NAX + NSE), 0,
                   B * (E + 1) * 8 + (NAX + NSE) * 28)
    # the vote kernel reads idx 4 + k 4 + isnb 1 + valid 1 bytes an event
    d["vote"] = (0, 0, 0, 0, 0, E * B * 10)
    d["pileup"] = (2 * FA + FA // 2, 2 * FA, 0, FA, 0,
                   FA * 36 + (FA // 2) * 12)
    # sort-based compactions: items + probe hits + amb + aux + sparse
    # events + agree contexts + site hits + active probe lanes + scan grids
    d["compact"] = (0, 0, 0, 0,
                    B * K + NI * (PG * 2 + scan_r + scan_s) + B * K * 2
                    + NA * 10 + NH * 10 + B * E + FA * cfg.sites_per_context
                    + NI * PG, 0)

    w = float(sum(v[0] for v in d.values()))
    r1 = float(sum(v[1] for v in d.values()))
    r5 = float(sum(v[2] for v in d.values()))
    s = float(sum(v[3] for v in d.values()))
    so = float(sum(v[4] for v in d.values()))
    byts = float(sum(v[5] for v in d.values()))
    return StepTraffic(bytes_total=byts, word_lanes=w, row128_lanes=r1,
                       row512_lanes=r5, scalar_lanes=s, sort_keys=so,
                       detail=d)


def roofline(cfg, dix, device_kind: str, B: int,
             measured_reads_per_sec: float,
             lowq_frac: float = 0.05,
             retry_frac: float = 0.25,
             gather_rates: dict | None = None) -> dict:
    """Roofline report. retry_frac: extra device work from the
    reverse-orientation retry batches (measured: retry reads / reads).
    gather_rates: a bench_gather result dict measured on this device."""
    tr = step_traffic(cfg, dix, B, lowq_frac=lowq_frac)
    mult = (1.0 + retry_frac) / B
    bw = device_hbm_gbps(device_kind) * 1e9
    bytes_per_read = tr.bytes_total * mult
    bw_bound = bw / bytes_per_read
    out = dict(
        device=device_kind,
        bytes_per_read=round(bytes_per_read, 1),
        lanes_per_read=dict(
            word=round(tr.word_lanes * mult, 1),
            row128=round(tr.row128_lanes * mult, 1),
            row512=round(tr.row512_lanes * mult, 1),
            scalar=round(tr.scalar_lanes * mult, 1),
            sort=round(tr.sort_keys * mult, 1)),
        bw_bound_reads_per_sec=round(bw_bound, 0),
        lane_bound_reads_per_sec=None,
        achieved_reads_per_sec=round(measured_reads_per_sec, 1),
        bw_roofline_frac=round(measured_reads_per_sec / bw_bound, 4),
        lane_roofline_frac=None,
    )
    rates = device_lane_rates(gather_rates)
    if rates is not None:
        lane_time_per_read = (tr.word_lanes / rates["word"]
                              + tr.row128_lanes / rates["row128"]
                              + tr.row512_lanes / rates["row512"]
                              + tr.scalar_lanes / rates["scalar"]
                              + tr.sort_keys / rates["sort"]) * mult
        lane_bound = 1.0 / lane_time_per_read
        out["lane_bound_reads_per_sec"] = round(lane_bound, 0)
        out["lane_roofline_frac"] = round(
            measured_reads_per_sec / lane_bound, 4)
    return out
