"""The trace reduction and the device-side readers over a hand-made
Chrome trace."""

from pytest import approx

from genobench import trace
from genobench.run import read_metrics


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(trace.STRETCH, "user_annotation", 1000, 1000),
    ev(trace.STRETCH, "gpu_user_annotation", 1000, 1000),
    ev("genobench.consume_fastq", "user_annotation", 1000, 800),
    ev("stage.dispatch", "user_annotation", 1000, 300),
    ev("stage.read_batch", "user_annotation", 1300, 200),
    ev("genobench.write_vcf", "user_annotation", 1800, 200),
    ev("void vote_kernel<4>(...)", "kernel", 1100, 100),
    ev("elementwise", "kernel", 1150, 100),     # overlaps the vote
    ev("Memcpy DtoH", "gpu_memcpy", 1500, 50),
    ev("Memset", "gpu_memset", 1900, 20),
    ev("elementwise", "kernel", 2500, 10),      # after the stretch
    ev("aten::add", "cpu_op", 1000, 5),
]


def test_summarize():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == approx(1000e-6)
    assert s["busy_s"] == approx((150 + 50 + 20) * 1e-6)
    assert s["device_ops"] == 4
    assert s["vote_kernel_launches"] == 1
    assert s["vote_kernel_s"] == approx(100e-6)
    gaps = {name: approx(t) for name, t in s["idle_gaps"]}
    assert [g[0] for g in s["idle_gaps"]] == [
        "genobench.consume_fastq", "stage.read_batch", "stage.dispatch",
        "genobench.write_vcf"]                       # longest first
    assert gaps == {"genobench.consume_fastq": 350e-6,   # 1550-1900
                    "stage.read_batch": 250e-6,          # 1250-1500
                    "stage.dispatch": 100e-6,            # 1000-1100
                    "genobench.write_vcf": 80e-6}        # 1920-2000


def test_device_readers():
    s = trace.summarize(EVENTS)
    s["batches"] = 2
    s["vote_launches"] = 1
    s["vote_events"] = [(4, 9)]
    entries = [{"name": n, "unit": u} for n, u in (
        ("device.idle_share", "fraction"), ("device.ops_per_batch", "ops"),
        ("vote_roofline", "%"))]
    m = read_metrics(entries, {"trace": s, "device_name": "x"})
    assert m["device.idle_share"]["value"] == approx(0.78)
    assert m["device.ops_per_batch"]["value"] == 2.0
    bound = 220 / 3.35e12
    assert abs(m["vote_roofline"]["value"] - 100 * bound / 100e-6) < 1e-9


def test_readers_without_trace():
    entries = [{"name": "device.idle_share", "unit": "fraction"},
               {"name": "vote_roofline", "unit": "%"}]
    assert read_metrics(entries, {"trace": None, "device_name": "x"}) == {}
