"""Device time by program span over a hand-made Chrome trace with launch
correlations."""

from pytest import approx

from genobench import spans, trace
from genobench.tests.test_genobench_trace import EVENTS, ev

MAIN, PRODUCER = 1, 2


def op(name, cat, ts, dur, corr):
    return dict(ev(name, cat, ts, dur), args={"correlation": corr})


def launch(ts, corr, tid=MAIN, cat="cuda_runtime"):
    return dict(ev("cudaLaunchKernel", cat, ts, 2), tid=tid,
                args={"correlation": corr})


def host(name, ts, dur, tid=MAIN):
    return dict(ev(name, "user_annotation", ts, dur), tid=tid)


# the stretch 1000-2000: a dispatch stage holding step.lookup (two kernels)
# and step.vote, an upload on the producer thread, a copy launched in the
# dispatch stage outside any step span, a kernel launched outside every
# program span, and one with no launch event
CORRELATED = [
    ev(trace.STRETCH, "user_annotation", 1000, 1000),
    host("genobench.consume_fastq", 1000, 800),
    host("stage.dispatch", 1010, 300),
    host("step.lookup", 1020, 100),
    host("step.vote", 1150, 100),
    host("stage.producer.upload", 1000, 50, PRODUCER),
    launch(1030, 1), op("k_lookup", "kernel", 1100, 40, 1),
    launch(1040, 2), op("k_lookup", "kernel", 1130, 40, 2),   # overlaps
    launch(1160, 3, cat="cuda_driver"),
    op("void vote_kernel<4>(...)", "kernel", 1300, 100, 3),
    launch(1280, 4), op("Memcpy DtoH", "gpu_memcpy", 1450, 50, 4),
    launch(1010, 5, PRODUCER), op("Memcpy HtoD", "gpu_memcpy", 1020, 30, 5),
    launch(1850, 6), op("elementwise", "kernel", 1900, 20, 6),
    op("elementwise", "kernel", 1950, 10, 99),
    launch(2100, 7), op("k_after", "kernel", 2200, 10, 7),   # past it
]


def test_device_by_span_innermost_at_launch():
    got = {n: (s, k) for n, s, k in spans.device_by_span(CORRELATED)}
    assert got == {"step.lookup": (approx(70e-6), 2),    # 1100-1170
                   "step.vote": (approx(100e-6), 1),
                   "stage.dispatch": (approx(50e-6), 1),
                   "stage.producer.upload": (approx(30e-6), 1),
                   "other": (approx(30e-6), 2)}
    order = [r[0] for r in spans.device_by_span(CORRELATED)]
    assert order[0] == "step.vote"


def test_device_by_span_covers_every_device_op_of_summarize():
    s = trace.summarize(CORRELATED)
    rows = spans.device_by_span(CORRELATED)
    assert sum(k for _, _, k in rows) == s["device_ops"] == 6 + 1


def test_existing_keys_unchanged_by_correlation_args():
    # EVENTS with launch events and correlation args on every device op
    extra = [dict(e, args={"correlation": i}) if e["cat"] in
             trace.DEVICE_CATS else e for i, e in enumerate(EVENTS)]
    extra += [launch(e["ts"] - 5, i) for i, e in enumerate(EVENTS)
              if e["cat"] in trace.DEVICE_CATS]
    assert trace.summarize(extra) == trace.summarize(EVENTS)


def test_span_counts_in_the_stretch():
    evs = CORRELATED + [host("step.vote", 2500, 10)]   # after the stretch
    assert spans.span_counts(evs) == {
        "stage.dispatch": 1, "stage.producer.upload": 1, "step.lookup": 1,
        "step.vote": 1}


def test_innermost_of_nested_and_sibling_spans():
    s = [(0, 100, "a"), (10, 20, "b"), (20, 30, "c"), (25, 26, "d"),
         (200, 300, "e")]
    assert spans._innermost(s, [0, 10, 19.5, 20, 25, 26, 50, 150, 250]) == [
        "a", "b", "b", "c", "d", "c", "a", None, "e"]
