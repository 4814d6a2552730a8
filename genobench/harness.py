"""One run of a cell, on any torch device: the inputs from the seed, the
index built in memory, the runner placed, the warm-up, the measured
window of whole samples, the optional traced stretch, and the
measurements the metric readers take their numbers from.

A sample is one genotyping of the cell's FASTQ from fresh pileup counts
through ``consume_fastq`` and ``write_vcf``, exactly as the CLI's ``geno``
runs it on an index already placed. Every sample reads the same FASTQ,
so every sample has the same answer.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import time

import numpy as np
import torch

from . import gen, trace as trace_mod

WARM_MAX = 3          # warm-up samples at most (see ``warm``)
STRETCH_SAMPLES = 1   # whole samples in the traced stretch


@dataclasses.dataclass
class Placed:
    runner: object
    index: object
    inputs: gen.Inputs
    setup: dict           # seconds by part
    geno_config: object


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def geno_config(cell):
    """The GenoConfig the CLI's ``geno`` builds for these inputs, as the
    configuration file stores it, at the mix's batch."""
    from vargeno_tpu_torch.config import GenoConfig

    return GenoConfig(**cell.config["geno"],
                      batch_reads=int(cell.mix["batch_reads"]))


def make_runner(cell, index, cfg, device: str, vote=None):
    """The configuration's runner class over ``index``: ``runner.mesh``
    set means a mesh of that many devices (``device`` repeated on the
    host), else one device."""
    spec = cell.config["runner"]
    cls = getattr(importlib.import_module(spec["module"]), spec["class"])
    kw = dict(queued_orientation=bool(spec.get("queued_orientation", True)))
    if vote is not None:
        kw["vote"] = vote
    if spec.get("mesh"):
        from vargeno_tpu_torch.dist.sharding import make_mesh

        n = int(spec["mesh"])
        mesh = make_mesh(n, devices=None if torch.device(device).type ==
                         "cuda" else [device] * n)
        return cls(index, mesh, cfg, **kw)
    return cls(index, cfg, device=device, **kw)


def place(cell, seed: int, work: str, device: str, t_start: float,
          vote=None) -> Placed:
    """Inputs, index and runner: every part of set-up but the warm-up."""
    from vargeno_tpu_torch.index.build import build_index

    setup = {}
    t = time.perf_counter()
    setup["imports_s"] = t - t_start
    inputs = gen.make_inputs(seed, cell.config, cell.mix, work)
    setup["synth_s"] = time.perf_counter() - t
    cfg = geno_config(cell)
    parts = {}
    index = build_index(inputs.fasta, inputs.vcf, os.path.join(work, "index"),
                        cfg, write_native=False, timings=parts)
    setup["index_build_s"] = sum(parts.values())
    t = time.perf_counter()
    runner = make_runner(cell, index, cfg, device, vote)
    sync(runner.device)
    setup["place_s"] = time.perf_counter() - t
    return Placed(runner, index, inputs, setup, cfg)


def overflow(runner) -> int:
    return sum(v for k, v in runner.stats_totals.items() if "overflow" in k)


CPU_STATES = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
              "steal")


def host_cpu() -> dict:
    """The machine's CPU seconds by state since boot, all cores summed
    (the first line of /proc/stat); empty where there is none."""
    try:
        with open("/proc/stat") as f:
            v = f.readline().split()[1:]
    except OSError:
        return {}
    hz = os.sysconf("SC_CLK_TCK")
    return {k: int(x) / hz for k, x in zip(CPU_STATES, v)}


@dataclasses.dataclass
class Sample:
    vcf: str | None
    seconds: float
    vcf_s: float
    overflow_left: int
    cpu_s: float          # this process's CPU seconds, all its threads
    stages: dict          # the runner's stage seconds in this sample


def sample(runner, inputs: gen.Inputs, out: str) -> Sample:
    """One sample from fresh counts: the FASTQ consumed, the VCF written."""
    t0 = time.perf_counter()
    c0 = time.process_time()
    st0 = dict(runner.timer.totals)
    ovf = overflow(runner)
    runner.ref_cnt, runner.alt_cnt = runner._fresh_counts()
    with trace_mod.span("genobench.consume_fastq"):
        runner.consume_fastq(inputs.fastq)
    t1 = time.perf_counter()
    with trace_mod.span("genobench.write_vcf"):
        runner.write_vcf(inputs.vcf, out)
    t2 = time.perf_counter()
    return Sample(out if os.path.exists(out) else None, t2 - t0, t2 - t1,
                  overflow(runner) - ovf, time.process_time() - c0,
                  delta(dict(runner.timer.totals), st0, 0.0))


def warm(runner, inputs: gen.Inputs, work: str) -> int:
    """Run samples until one leaves the runner's configuration and its
    escalation count as it found them (the first sample also builds the
    kernels and tunes the capacities); returns the samples run."""
    for i in range(WARM_MAX):
        cfg, esc = runner._cfg_run, runner.n_escalations
        sample(runner, inputs, os.path.join(work, "warm.vcf"))
        if i and runner._cfg_run == cfg and runner.n_escalations == esc:
            break
    sync(runner.device)
    return i + 1


def counters(runner) -> dict:
    return dict(reads=runner.n_reads, retry_reads=runner.n_retry_reads,
                retry_batches=runner.n_retry_batches,
                escalations=runner.n_escalations, rewinds=runner.n_rewinds)


def delta(after: dict, before: dict, missing=None) -> dict:
    return {k: after[k] - before.get(k, missing) for k in after}


@dataclasses.dataclass
class Window:
    samples: list
    seconds: float
    reads: int
    stages: dict          # GenoRunner.timer seconds by stage
    counts: dict          # runner counters over the window
    vcf_s: float
    cpu: dict             # the machine's CPU seconds by state, and this
                          # process's (``own``), over the window


def window(runner, inputs: gen.Inputs, seconds: float, work: str) -> Window:
    """Whole samples back to back until ``seconds`` have passed; the window
    ends when the last sample's VCF is closed."""
    from vargeno_tpu_torch.utils.profiling import StageTimer

    runner.timer = StageTimer(sync=False)
    before = counters(runner)
    samples = []
    cpu0, own0 = host_cpu(), time.process_time()
    t0 = time.perf_counter()
    while True:
        samples.append(sample(runner, inputs, os.path.join(
            work, f"sample{len(samples)}.vcf")))
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    cpu = dict(delta(host_cpu(), cpu0), own=time.process_time() - own0)
    c = delta(counters(runner), before)
    return Window(samples, elapsed, c["reads"], dict(runner.timer.totals),
                  c, sum(s.vcf_s for s in samples), cpu)


class VoteCounter:
    """The vote entry the runner is built with in a traced run: it calls
    the program's vote and counts launches; while ``counting`` it also
    keeps each launch's reads and its event total (each read's count
    clamped to the record width) on the device, read once at the end
    (``launch_events``)."""

    def __init__(self, vote=None):
        if vote is None:
            from vargeno_tpu_torch.kernels.vote import vote_scan_records

            vote = vote_scan_records
        self.vote = vote
        self.launches = 0
        self.counting = False
        self._rec: list = []

    def __call__(self, ev_idx, meta, ev_total, C):
        self.launches += 1
        if self.counting:
            B, E = ev_idx.shape
            self._rec.append((B, ev_total.clamp(0, E).sum()))
        return self.vote(ev_idx, meta, ev_total, C)

    def launch_events(self) -> list:
        """[(reads, events)] of the counted launches."""
        out = [(B, int(n)) for B, n in self._rec]
        self._rec.clear()
        return out


def traced_stretch(runner, inputs: gen.Inputs, work: str, cell,
                   vote: VoteCounter) -> dict:
    """Profile STRETCH_SAMPLES whole samples, then count the vote's events
    over one more untraced sample (the same launches: the same FASTQ
    through the same tuned configuration). Returns the trace's
    measurements."""
    from torch.profiler import ProfilerActivity, profile

    from vargeno_tpu_torch.utils.profiling import StageTimer

    on_cuda = torch.device(runner.device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda
                                     else [])
    runner.timer = trace_mod.AnnotatedTimer()
    before = counters(runner)
    launches0 = vote.launches
    sync(runner.device)
    with profile(activities=acts) as prof:
        with trace_mod.span(trace_mod.STRETCH):
            for i in range(STRETCH_SAMPLES):
                sample(runner, inputs, os.path.join(work, f"traced{i}.vcf"))
            sync(runner.device)
    c = delta(counters(runner), before)
    launches = vote.launches - launches0
    path = os.path.join(work, "trace.json")
    prof.export_chrome_trace(path)
    del prof
    runner.timer = StageTimer(sync=False)
    summary = trace_mod.summarize(trace_mod.load(path))
    os.remove(path)

    vote.counting = True
    sample(runner, inputs, os.path.join(work, "counted.vcf"))
    vote.counting = False
    events = vote.launch_events()

    loop = int(cell.mix["batch_reads"]) * int(cell.config["runner"].get(
        "mesh") or 1)
    fwd = STRETCH_SAMPLES * -(-inputs.n_reads // loop)
    summary["batches"] = (fwd + c["retry_batches"] + c["escalations"]
                          + c["rewinds"])
    summary["vote_launches"] = launches
    summary["vote_events"] = events if len(events) == launches else None
    return summary


def program_counts(runner, index, max_cov: int) -> dict:
    """The program's pileup counts after its last sample, by site
    position, each saturated at ``max_cov`` as the calls read them."""
    rc, ac = runner.host_counts()
    pos = np.asarray(index.sites.pos, np.int64)
    n = pos.shape[0]
    rc = np.minimum(rc[:n], max_cov).tolist()
    ac = np.minimum(ac[:n], max_cov).tolist()
    return {p: (r, a) for p, r, a in zip(pos.tolist(), rc, ac)}
