"""Roofline accounting and profiling helpers of the port against the JAX
package's ``utils/roofline.py`` / ``utils/profiling.py`` on the same config,
index shape and rates dict. Lane counts are integers (exact); the report's
floats agree to 1e-9 relative. The ``vote`` stage differs on purpose: the
port's kernel reads 10 B an event, the Pallas kernel's streams 8."""

import json
import types

import numpy as np
import pytest
import torch

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.utils import roofline as jroof
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.utils import profiling, roofline

RATES = dict(word_gather_1048576=2.0e10, row_gather_1048576=1.6e9,
             row_gather_512B=1.5e9, scatter_rows=5.0e9,
             scatter_scalar=4.0e9, device_sort_u32=9.0e9)
CONFIGS = {
    "default": dict(batch_reads=32768),
    "tuned": dict(batch_reads=4096, events_per_read=24, probe_hit_cap=9,
                  neighbor_item_frac=0.02, probe_active_frac=0.07,
                  scan_active_frac=0.11, agree_cap=2, scan_slot_cap=8,
                  sparse_events_frac=0.03, sites_per_context=8),
}


def _dix(big: bool):
    """The index fields the traffic model reads, as both packages name
    them; ``big`` gives a ref block past the big-block threshold."""
    return types.SimpleNamespace(
        both_ht=np.zeros((8, 128), np.uint32), both_ht_chain=2 if big else 1,
        ref_win_rows=3, ref_scan_max=150 if big else 7, snp_scan_max=11)


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_traffic_matches_jax(name, big):
    kw = CONFIGS[name]
    B = kw["batch_reads"]
    got = roofline.step_traffic(GenoConfig(**kw), _dix(big), B)
    want = jroof.step_traffic(JConfig(**kw), _dix(big), B)
    assert sorted(got.detail) == sorted(want.detail)
    for stage, lanes in want.detail.items():
        if stage != "vote":
            assert got.detail[stage] == lanes, stage
    E = GenoConfig(**kw).events_per_read
    assert got.detail["vote"] == (0, 0, 0, 0, 0, E * B * 10)
    assert want.detail["vote"] == (0, 0, 0, 0, 0, E * B * 8)
    for f in ("word_lanes", "row128_lanes", "row512_lanes", "scalar_lanes",
              "sort_keys"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.bytes_total == want.bytes_total + E * B * 2


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_roofline_report_matches_jax(name):
    kw = CONFIGS[name]
    B = kw["batch_reads"]
    args = ("cpu", B, 650000.0)
    opts = dict(retry_frac=0.5019, gather_rates=RATES)
    got = roofline.roofline(GenoConfig(**kw), _dix(False), *args, **opts)
    want = jroof.roofline(JConfig(**kw), _dix(False), *args, **opts)
    assert sorted(got) == sorted(want)
    # everything lane-side is the same arithmetic on the same rates
    assert got["lanes_per_read"] == want["lanes_per_read"]
    for key in ("lane_bound_reads_per_sec", "lane_roofline_frac",
                "achieved_reads_per_sec"):
        assert got[key] == pytest.approx(want[key], rel=1e-9), key
    # the bytes side carries the vote kernel's two extra bytes an event
    E = GenoConfig(**kw).events_per_read
    extra = E * B * 2 * (1 + 0.5019) / B
    assert got["bytes_per_read"] == pytest.approx(
        want["bytes_per_read"] + extra, abs=0.11)
    bw = roofline.device_hbm_gbps("cpu") * 1e9
    assert bw == jroof.device_hbm_gbps("cpu") * 1e9
    assert got["bw_bound_reads_per_sec"] == pytest.approx(
        bw / got["bytes_per_read"], rel=1e-4)
    json.dumps(got)


def test_no_rates_means_no_lane_bound():
    cfg = GenoConfig(batch_reads=4096)
    rep = roofline.roofline(cfg, _dix(False), "NVIDIA H100 80GB HBM3", 4096,
                            500000.0)
    assert rep["lane_bound_reads_per_sec"] is None
    assert rep["lane_roofline_frac"] is None
    assert rep["bw_bound_reads_per_sec"] > 0
    assert roofline.device_lane_rates(None) is None
    # a rate the bench reported as implausible (null) gives no bound either
    assert roofline.device_lane_rates(dict(RATES, row_gather_512B=None)) \
        is None
    assert roofline.device_lane_rates(RATES) == dict(
        word=2.0e10, row128=1.6e9, row512=1.5e9, scalar=4.0e9, sort=9.0e9)


def test_device_table_carries_no_tpu():
    assert roofline.device_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert not any("tpu" in k.lower() for k in roofline.DEVICE_HBM_GBPS)
    assert not hasattr(roofline, "DEVICE_LANE_RATES")
    # an unknown card gets no other device's rate
    with pytest.raises(ValueError):
        roofline.device_hbm_gbps("NVIDIA A100-SXM4-80GB")


def test_meter_and_stage_timer(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = profiling.Meter(path)
    m.bump(512, retries=3)
    m.bump(100)
    snap = m.emit()
    assert (snap["reads"], snap["batches"], snap["retries"]) == (612, 2, 3)
    assert json.loads(open(path).read()) == snap
    st = profiling.StageTimer()
    with st.stage("a", block_on=torch.device("cpu")):
        pass
    with st.stage("a"):
        pass
    assert st.counts == {"a": 2} and "a" in st.report()
    assert profiling.device_ms(lambda: None, "cpu", reps=3) >= 0.0


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.arange(10).sum()
    doc = json.loads(open(tmp_path / "tr" / "trace.json").read())
    assert "traceEvents" in doc
