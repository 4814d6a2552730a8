"""Per-stage times of one batch step of the bench workload (port of
``tools/profile_tpu.py`` ``main``).

    python -m vargeno_tpu_torch.tools.profile_step [--device cuda|cpu]
        [--reps N]

The input is the first forward batch of the bench workload
(``tools/bench.py``: its dataset and index, found through the same
``VGT_BENCH_*`` knobs) at the bench's batch size and capacities. One run of
``BatchProcessor.single_enc`` with recording wrappers on the processor and
backend instances keeps each stage's own arguments (the step's code is not
changed); its counts must equal a plain ``single_enc``'s. Then each stage is
called directly on its arguments, after one warm-up run, ``--reps`` times:

  encode (host, ``native.encode_batch``) and the upload to the device;
  the whole ``single_enc``, and inside it ``exact_both`` over B x K,
  ``neighbor_probes`` over the NI items (inside it ``exact_both_sparse``
  on the probe grid, ``ref_scan`` and ``snp_scan``),
  ``expand_probe_events`` over the NH probe hits, ``vote_scan_records`` on
  the step's records and ``pileup_accumulate``.

For each: the median milliseconds between CUDA events round one call (on
the CPU, the host clock) and the median host milliseconds to issue it (the
call's own wall time before any synchronise). The whole step less its
top-level stages is the remainder: the compactions and event scatters of
``orientation_pass``. Where the event time is near the host time, the stage
waits on the host. Prints a table, then one JSON line
``{"profile_step": ...}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from . import bench

# (name, depth): the table's rows; depth-1 rows add up to the step
STAGES = (("encode (host)", 0), ("upload", 0), ("single_enc", 0),
          ("exact_both", 1), ("neighbor_probes", 1),
          ("exact_both_sparse", 2), ("ref_scan", 2), ("snp_scan", 2),
          ("expand_probe_events", 1), ("vote_scan_records", 1),
          ("pileup_accumulate", 1), ("remainder", 1))


def stage_ms(fn, device, reps: int):
    """(median ms between CUDA events round one call -- host clock on the
    CPU --, median host ms to issue the call) over ``reps`` runs after one
    warm-up run."""
    on_cuda = torch.device(device).type == "cuda"
    fn()
    bench.sync(device)
    dev_ms, host_ms = [], []
    for _ in range(reps):
        if on_cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        if on_cuda:
            b.record()
            b.synchronize()
            dev_ms.append(a.elapsed_time(b))
        else:
            dev_ms.append(host)
        host_ms.append(host)
    return statistics.median(dev_ms), statistics.median(host_ms)


def _recorder(name, fn, seen: dict):
    def wrapped(*args):
        seen.setdefault(name, args)
        return fn(*args)
    return wrapped


def capture(proc, args, counts) -> tuple:
    """One ``single_enc`` run whose stages keep their first call's
    arguments; returns (the run's outputs, {stage: args}). The wrappers sit
    on the instances only and are taken off again."""
    seen: dict = {}
    base = proc.backend_factory

    def recording_factory(dix):
        be = base(dix)
        for name in ("exact_both", "exact_both_sparse", "ref_scan",
                     "snp_scan"):
            setattr(be, name, _recorder(name, getattr(be, name), seen))
        return be

    names = ("neighbor_probes", "expand_probe_events", "pileup_accumulate")
    proc.backend_factory = recording_factory
    for name in names:
        setattr(proc, name, _recorder(name, getattr(proc, name), seen))
    vote = proc.vote
    proc.vote = _recorder("vote_scan_records", vote, seen)
    try:
        out = proc.single_enc(*args, *counts)
    finally:
        proc.backend_factory = base
        proc.vote = vote
        for name in names:
            delattr(proc, name)
    return out, seen


def profile(wl: bench.Workload, device, reps: int = 20) -> dict:
    from .. import native
    from ..engine.batch import make_batch_processor
    from ..engine.device_index import build_device_index
    from ..engine.geno import upload
    from ..io.fastq import iter_read_batches

    device = torch.device(device)
    cfg = bench.bench_config(wl)
    B, K = cfg.batch_reads, cfg.max_kmers_per_read
    with bench.stage("index load + device tables"):
        dix = build_device_index(bench.load_index(wl), device,
                                 cfg.ht_target_load)
        bench.sync(device)
    if not native.available():
        raise RuntimeError("the native host library failed to build")
    b = next(iter(iter_read_batches(wl.fq, B, cfg.max_read_len, K)))
    enc = native.encode_batch(b.codes, b.n_kmers, K)
    args = upload(device, enc, b.qual)
    proc = make_batch_processor(dix, cfg)
    z = torch.zeros(dix.n_sites + 1, dtype=torch.int32, device=device)
    counts = (z, torch.zeros_like(z))

    out, seen = capture(proc, args, counts)
    plain = proc.single_enc(*args, *counts)
    for a, b_, what in ((out[0], plain[0], "ref counts"),
                        (out[1], plain[1], "alt counts"),
                        (out[2], plain[2], "process bits")):
        if not torch.equal(a, b_):
            raise AssertionError(f"the recorded step's {what} differ from "
                                 f"a plain single_enc's")
    missing = [n for n, depth in STAGES
               if depth and n != "remainder" and n not in seen]
    if missing:
        raise AssertionError(f"the step did not reach {missing}")

    def fresh(name):
        """Stage ``name`` on a fresh backend each call (a backend memoizes
        block bounds on the query tensor, and counts lanes as it goes)."""
        return lambda: getattr(proc._backend(), name)(*seen[name])

    np_ = seen["neighbor_probes"]
    calls = {
        "encode (host)": lambda: native.encode_batch(b.codes, b.n_kmers, K),
        "upload": lambda: upload(device, enc, b.qual),
        "single_enc": lambda: proc.single_enc(*args, *counts),
        "exact_both": fresh("exact_both"),
        "neighbor_probes": lambda: proc.neighbor_probes(proc._backend(),
                                                        *np_[1:]),
        "exact_both_sparse": fresh("exact_both_sparse"),
        "ref_scan": fresh("ref_scan"),
        "snp_scan": fresh("snp_scan"),
        "expand_probe_events": lambda: proc.expand_probe_events(
            *seen["expand_probe_events"]),
        "vote_scan_records": lambda: proc.vote(*seen["vote_scan_records"]),
        "pileup_accumulate": lambda: proc.pileup_accumulate(
            *seen["pileup_accumulate"]),
    }
    times = {name: stage_ms(fn, device, reps) for name, fn in calls.items()}
    top = [n for n, depth in STAGES if depth == 1 and n != "remainder"]
    times["remainder"] = tuple(
        times["single_enc"][i] - sum(times[n][i] for n in top)
        for i in range(2))
    ev_idx = seen["vote_scan_records"][0]
    shapes = dict(B=B, K=K, NI=int(np_[1].shape[0]),
                  NH=int(seen["expand_probe_events"][0].shape[0]),
                  E=int(ev_idx.shape[1]),
                  C=int(seen["vote_scan_records"][3]),
                  events=int(seen["vote_scan_records"][2].clamp(
                      max=ev_idx.shape[1]).sum()))
    return dict(device=bench.device_label(device),
                shapes=shapes, reps=reps,
                stages={n: {"ms": round(times[n][0], 4),
                            "host_ms": round(times[n][1], 4)}
                        for n, _ in STAGES},
                counts={"ref": int(out[0].sum()), "alt": int(out[1].sum()),
                        "processed": int(out[2].sum())})


def table(res: dict) -> str:
    sh = res["shapes"]
    lines = [f"one forward step of the bench workload on {res['device']}: "
             f"B={sh['B']} K={sh['K']} NI={sh['NI']} NH={sh['NH']} "
             f"(E, C)=({sh['E']}, {sh['C']}), {sh['events']} events; "
             f"median of {res['reps']} runs",
             f"{'stage':28s} {'ms (events)':>12s} {'host ms':>10s}"]
    for name, depth in STAGES:
        t = res["stages"][name]
        lines.append(f"{'  ' * depth + name:28s} {t['ms']:12.4f} "
                     f"{t['host_ms']:10.4f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.profile_step",
        description="per-stage times of one batch step")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if bench.no_card(args.device):
        return 1
    res = profile(bench.Workload.from_env(), args.device, args.reps)
    print(table(res))
    print(json.dumps({"profile_step": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
