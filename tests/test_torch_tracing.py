"""The port's spans and stages on the profiler's clock, on the CPU: the span
primitive with and without a profiler, ``StageTimer`` from two threads,
every operation of each step kind under one innermost ``step.*`` span,
the host loop's stages (main thread, producer thread, retry issue, the
VCF writer, the multi-process loop) against the runner's own counters,
and the CLI's ``--metrics`` stages and ``--trace-dir`` trace."""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_index_share import FIX, head_fastq, small_index

from vargeno_tpu_torch import cli
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
from vargeno_tpu_torch.dist.sharding import make_mesh
from vargeno_tpu_torch.engine.batch import make_batch_processor
from vargeno_tpu_torch.engine.cohort import CohortRunner
from vargeno_tpu_torch.engine.device_index import build_device_index
from vargeno_tpu_torch.engine.geno import (GenoRunner, _encoder, step_vec,
                                           upload)
from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.io.fastq import iter_read_batches
from vargeno_tpu_torch.kernels.vote import vote_scan_records
from vargeno_tpu_torch.utils import profiling
from vargeno_tpu_torch.utils.profiling import StageTimer, span

torch.set_num_threads(2)

FQ = os.path.join(FIX, "reads.fq")
VCF = os.path.join(FIX, "snps.vcf")
CFG = GenoConfig(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
PASS_SPANS = {"step.lookup", "step.records", "step.probes", "step.vote"}


def profiled(fn, all_threads=False):
    """(fn(), the profiler's events) with fn run inside a span
    ``test.outer``."""
    cfg = profiling._all_threads() if all_threads else None
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=cfg) as prof:
        with torch.profiler.record_function("test.outer"):
            out = fn()
    return out, prof.events()


def innermost_span(e):
    """The innermost user span around a profiler event."""
    p = e.cpu_parent
    while p is not None and not p.is_user_annotation:
        p = p.cpu_parent
    return p


def names(events, prefix=""):
    return [e.name for e in events
            if e.is_user_annotation and e.name.startswith(prefix)]


class CountingVote:
    def __init__(self):
        self.calls = 0

    def __call__(self, *a):
        self.calls += 1
        return vote_scan_records(*a)


@pytest.fixture(scope="module")
def index():
    return small_index()


# --- the span primitive and the stage timer ---

def test_span_is_a_shared_null_context_without_a_profiler():
    a, b = span("step.lookup"), span("stage.dispatch")
    assert a is b
    assert not isinstance(a, torch.profiler.record_function)
    with a:
        pass


def test_span_records_under_the_profiler():
    def body():
        s = span("step.lookup")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            return torch.ones(4).sum()

    _, events = profiled(body)
    (lk,) = [e for e in events if e.name == "step.lookup"]
    assert lk.is_user_annotation
    assert innermost_span(next(e for e in events if e.name == "aten::sum")) \
        is lk
    assert isinstance(span("x"), type(profiling._NO_SPAN))   # off again


def test_stage_is_the_span_stage_name():
    st = StageTimer(sync=False)

    def body():
        with st.stage("read_batch"):
            torch.zeros(3)
        with st.stage("read_batch"):
            pass

    _, events = profiled(body)
    assert names(events, "stage.") == ["stage.read_batch"] * 2
    assert st.counts == {"read_batch": 2} and st.totals["read_batch"] > 0
    with st.stage("dispatch"):   # no profiler: timed all the same
        pass
    assert st.counts == {"read_batch": 2, "dispatch": 1}


def test_stage_timer_totals_exact_from_two_threads(monkeypatch):
    # each thread's clock moves 1 s a reading, so every stage lasts 1 s
    clock = threading.local()

    def tick():
        clock.t = getattr(clock, "t", 0) + 1
        return float(clock.t)

    monkeypatch.setattr(profiling.time, "perf_counter", tick)
    st = StageTimer(sync=False)
    n = 3000
    go = threading.Barrier(2)

    def work(tag):
        go.wait()
        for i in range(n):
            with st.stage("shared"):
                pass
            with st.stage(f"{tag}.{i % 50}"):   # new keys while the other
                pass                            # thread writes
            snap = dict(st.totals)              # a reader's copy
            assert snap["shared"] >= 1

    ts = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert st.counts["shared"] == 2 * n and st.totals["shared"] == 2 * n
    for tag in "ab":
        for j in range(50):
            assert st.counts[f"{tag}.{j}"] == n // 50
            assert st.totals[f"{tag}.{j}"] == n // 50


# --- every operation of a step under one innermost step span ---

@pytest.fixture(scope="module")
def step_parts(index):
    dix = build_device_index(index, "cpu", CFG.ht_target_load)
    b = next(iter(iter_read_batches(FQ, CFG.batch_reads, CFG.max_read_len,
                                    CFG.max_kmers_per_read)))
    enc = _encoder(CFG.max_kmers_per_read)(b.codes, b.n_kmers)
    return dix, b, enc


def _step(kind, index, step_parts):
    """(call, passes, spans expected) of one step of ``kind``."""
    dix, b, enc = step_parts
    z = torch.zeros(dix.n_sites + 1, dtype=torch.int32)
    dev = torch.device("cpu")
    proc = make_batch_processor(dix, CFG)
    if kind == "routed":
        runner = ShardedDictGenoRunner(index, make_mesh(devices=["cpu"]),
                                       CFG)
        proc = runner._proc(runner._cfg_run)[0]
        z = runner._fresh_counts()[0][0]
    z2 = z.clone()
    base = PASS_SPANS | {"step.pileup", "step.pack"}
    if kind in ("single_enc", "routed"):
        args = upload(dev, enc, b.qual)
        return (lambda: step_vec(proc, args, "enc", z, z2), 1,
                base | ({"step.route"} if kind == "routed" else set()))
    if kind == "single":
        args = [torch.from_numpy(np.ascontiguousarray(a))
                for a in (b.codes, b.n_kmers, b.qual)]
        return (lambda: step_vec(proc, args, "codes", z, z2), 1,
                base | {"step.encode"})
    if kind == "multi_enc":
        args = upload(dev, tuple(np.stack([a, a]) for a in enc),
                      np.stack([b.qual, b.qual]))
        return lambda: step_vec(proc, args, "group", z, z2), 2, base
    if kind == "dual_enc":
        args = upload(dev, enc, b.qual, b.n_kmers)
        return (lambda: step_vec(proc, args, "dual", z, z2), 2,
                base | {"step.encode"})
    codes, nk, qual = (torch.from_numpy(np.ascontiguousarray(a))
                       for a in (b.codes, b.n_kmers, b.qual))
    return (lambda: proc.dual(codes, nk, qual, z, z2), 2,
            base | {"step.encode"})


@pytest.mark.parametrize("kind", ["single_enc", "single", "multi_enc",
                                  "dual_enc", "dual", "routed"])
def test_every_step_op_under_one_step_span(kind, index, step_parts):
    call, passes, expected = _step(kind, index, step_parts)
    _, events = profiled(call)
    ops = [e for e in events if not e.is_user_annotation]
    assert len(ops) > 100
    owners = [innermost_span(e) for e in ops]
    outside = sorted({e.name for e, o in zip(ops, owners)
                      if o is None or not o.name.startswith("step.")})
    assert outside == [], outside
    spans = names(events, "step.")
    assert set(spans) == expected
    assert spans.count("step.vote") == passes
    assert spans.count("step.lookup") == passes
    assert spans.count("step.records") == 2 * passes
    # step spans never nest, but for the routed exchange inside a query
    for e in events:
        if e.is_user_annotation and e.name.startswith("step."):
            parent = innermost_span(e)
            want = ("step.lookup", "step.probes") \
                if e.name == "step.route" else ("test.outer",)
            assert parent is not None and parent.name in want, e.name


# --- the host loop's stages against the runner's counters ---

@pytest.fixture(scope="module")
def traced_pass(index, tmp_path_factory):
    """A queued GenoRunner pass over the first 2,048 reads and its VCF
    under the profiler, every thread recorded."""
    d = tmp_path_factory.mktemp("pass")
    fq = head_fastq(FQ, str(d / "head.fq"), 2048)
    vote = CountingVote()
    runner = GenoRunner(index, CFG, device="cpu", vote=vote)
    out = str(d / "out.vcf")

    def run():
        runner.consume_fastq(fq)
        runner.write_vcf(VCF, out)

    _, events = profiled(run, all_threads=True)
    return runner, vote, events, open(out).read()


def test_pass_retry_dispatch_spans_equal_retry_batches(traced_pass):
    runner, _, events, vcf = traced_pass
    assert vcf.startswith("##fileformat") and runner.n_reads == 2048
    assert runner.n_retry_batches > 0
    assert names(events).count("stage.retry_dispatch") \
        == runner.timer.counts["retry_dispatch"] == runner.n_retry_batches


def test_pass_producer_stages_on_the_producer_thread(traced_pass):
    runner, _, events, _ = traced_pass
    fwd = -(-runner.n_reads // CFG.batch_reads)
    by_thread = {}
    for e in events:
        if e.is_user_annotation and e.name.startswith("stage."):
            by_thread.setdefault(e.thread, set()).add(e.name)
    producer = [t for t, n in by_thread.items() if "stage.producer.parse"
                in n]
    assert len(producer) == 1
    assert by_thread[producer[0]] == {"stage.producer.parse",
                                      "stage.producer.encode",
                                      "stage.producer.upload"}
    got = names(events)
    # every batch's parse, and the last parse that finds the end
    assert got.count("stage.producer.parse") \
        == runner.timer.counts["producer.parse"] == fwd + 1
    assert got.count("stage.producer.encode") == fwd
    assert got.count("stage.producer.upload") == fwd


def test_pass_vote_spans_equal_vote_calls(traced_pass):
    runner, vote, events, _ = traced_pass
    assert vote.calls == runner.n_retry_batches + \
        -(-runner.n_reads // CFG.batch_reads) + runner.n_escalations \
        + runner.n_rewinds
    assert names(events).count("step.vote") == vote.calls


def test_write_vcf_records_its_two_stages_once(traced_pass):
    runner, _, events, _ = traced_pass
    assert runner.timer.counts["vcf_calls"] == 1
    assert runner.timer.counts["vcf_write"] == 1
    assert names(events).count("stage.vcf_calls") == 1
    assert names(events).count("stage.vcf_write") == 1


def test_inline_dual_loop_records_its_stages(index):
    runner = GenoRunner(index, CFG, device="cpu", queued_orientation=False)
    runner.consume_fastq(FQ, limit_batches=3)
    c = runner.timer.counts
    assert c["dispatch"] == c["finalize_wait"] == 3
    assert c["read_batch"] == 3 and c["producer.encode"] >= 3
    assert "retry_dispatch" not in c


def test_cohort_write_vcfs_records_stages_per_sample(index, tmp_path):
    cohort = CohortRunner(index, ["a", "b"], CFG, device="cpu")
    for name in ("a", "b"):
        cohort.consume_sample(name, FQ, limit_batches=1)
    cohort.write_vcfs(VCF, str(tmp_path / "{sample}.vcf"))
    c = cohort._runner.timer.counts
    assert c["vcf_calls"] == c["vcf_write"] == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_queued_loop_records_stages_and_stats_gather(index):
    import torch.distributed as dist

    from vargeno_tpu_torch.dist import multihost

    cluster = multihost.initialize(f"tcp://localhost:{_free_port()}", 1, 0,
                                   "gloo", timeout=60)
    try:
        runner = multihost.MultiHostGenoRunner(
            index, multihost.ProcessMesh(cluster, ["cpu"]), CFG)
        runner.consume_fastq(FQ, limit_batches=3)
        c = runner.timer.counts
        finals = c["finalize_wait"]
        assert c["dispatch"] == 3 and c["read_batch"] == 3
        assert c["retry_dispatch"] == runner.n_retry_batches > 0
        assert finals == 3 + runner.n_retry_batches
        # one all-gather an attempt, inside finalize_wait
        assert c["stats_gather"] == finals + runner.n_escalations
        assert runner.timer.totals["stats_gather"] \
            <= runner.timer.totals["finalize_wait"]
    finally:
        dist.destroy_process_group()


# --- the CLI ---

@pytest.fixture(scope="module")
def cli_run(index, tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    prefix = str(d / "idx")
    store.save(prefix, index)
    t0 = time.time()
    rc = cli.main(["geno", prefix, FQ, VCF, str(d / "out.vcf"), "--device",
                   "cpu", "--batch-reads", "512", "--limit-batches", "2",
                   "--metrics", str(d / "m.jsonl"), "--trace-dir",
                   str(d / "trace")])
    return rc, d, t0


def test_cli_geno_metrics_line_carries_stages(cli_run):
    rc, d, _ = cli_run
    assert rc == 0
    snap = json.loads(open(d / "m.jsonl").read().splitlines()[-1])
    st = snap["stages"]
    assert {"read_batch", "dispatch", "finalize_wait", "producer.parse",
            "producer.encode", "producer.upload"} <= set(st)
    assert all(v > 0 for v in st.values())
    assert snap["reads"] > 0


def test_cli_geno_metrics_line_counts_vcf_rewrites(cli_run):
    """The line comes once the VCF is written: the rewrite's stages, and
    the one rewrite counted by the path that ran."""
    from vargeno_tpu_torch import native

    rc, d, _ = cli_run
    assert rc == 0
    snap = json.loads(open(d / "m.jsonl").read().splitlines()[-1])
    assert {"vcf_calls", "vcf_write"} <= set(snap["stages"])
    want = 1 if native.available() else 0
    assert (snap["n_vcf_native"], snap["n_vcf_fallback"]) == (want, 1 - want)


def test_cli_geno_trace_dir_holds_step_and_stage_spans(cli_run):
    rc, d, t0 = cli_run
    assert rc == 0
    path = d / "trace" / "trace.json"
    assert path.stat().st_mtime >= t0
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    spans = {e["name"] for e in ev if e.get("cat") == "user_annotation"}
    assert {"step.lookup", "step.probes", "step.vote", "stage.dispatch",
            "stage.producer.parse", "stage.vcf_calls",
            "stage.vcf_write"} <= spans


def test_trace_names_a_file_per_process(tmp_path):
    with profiling.trace(str(tmp_path), "trace.rank3.json"):
        with span("step.vote"):
            torch.ones(2)
    with open(tmp_path / "trace.rank3.json") as f:
        ev = json.load(f)["traceEvents"]
    assert any(e.get("name") == "step.vote" for e in ev)
    assert not (tmp_path / "trace.json").exists()
