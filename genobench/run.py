"""The benchmark of the PyTorch and CUDA port (``vargeno_tpu_torch``): one
run of one cell.

    python3 -m genobench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The run makes the cell's genome, SNP VCF and
FASTQ from the seed in a temporary directory, builds the index in memory
with the port's ``build_index``, places it through the configuration's
runner, warms up on whole samples, then genotypes whole samples back to
back for ``--seconds`` (the window). With ``--trace 1`` it then profiles
a stretch of whole samples. Last, with the program's state freed, the
plain reference (``genobench.reference``) judges the timed samples'
outputs.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (samples), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number
with its limit; those numbers are also the last lines of standard error.
The run exits 1 and prints no result when no CUDA card (or fewer than the
cell asks for) is visible, or when a module of JAX or of the JAX package
is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vargeno_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str):
    from . import spec

    s = importlib.util.spec_from_file_location(
        "genobench.metrics." + name.replace(".", "_"), spec.metric_path(name))
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, m: dict) -> dict:
    """Each metric's reader over the measurements ``m``; a reader that
    finds nothing to read leaves its metric out."""
    out = {}
    for e in entries:
        v = load_reader(e["name"])(m)
        if v is not None:
            out[e["name"]] = {"value": v, "unit": e["unit"]}
    return out


def measure(cell, seed: int, seconds: float, trace: bool, device: str,
            work: str, t_start: float = T_START,
            n_sites: int | None = None) -> dict:
    """One run on ``device``; returns the result object. The reference
    checks ``check.N_SITES`` sites unless ``n_sites`` says fewer."""
    import torch

    from . import harness
    from .reference import check

    vote = harness.VoteCounter() if trace else None
    p = harness.place(cell, seed, work, device, t_start, vote)
    p.setup["warm_samples"] = harness.warm(p.runner, p.inputs, work)
    setup_s = time.perf_counter() - t_start
    win = harness.window(p.runner, p.inputs, seconds, work)
    on_cuda = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0
    tr = (harness.traced_stretch(p.runner, p.inputs, work, cell, vote)
          if trace else None)
    counts = harness.program_counts(p.runner, p.index, p.geno_config.max_cov)
    cfg, inputs, setup = p.geno_config, p.inputs, p.setup
    del p
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = check.run(inputs.fasta, inputs.vcf, inputs.fastq, cfg.ref_bf_bits,
                    cfg.snp_bf_bits, n_sites or check.N_SITES, seed)
    numbers = check.judge(ref, [s.vcf for s in win.samples], counts)
    failed = sum(1 for s in win.samples if s.vcf is None or s.overflow_left)

    m = dict(window_s=win.seconds, reads=win.reads, setup_s=setup_s,
             stages=win.stages, counts=win.counts, vcf_s=win.vcf_s,
             setup=setup, trace=tr,
             device_name=(torch.cuda.get_device_name() if on_cuda
                          else "cpu"))
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": m["device_name"], "count": cell.chips,
           "memory_peak_bytes": peak}
    res = {"correct": all(numbers[k] <= check.LIMITS[k] for k in numbers),
           "attempted": len(win.samples), "failed": failed,
           "metrics": read_metrics(cell.per_layer if trace
                                   else cell.end_to_end, m),
           "device": dev}
    if tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        res["breakdown"] = {
            "device_ops": [[n, s] for n, s, _ in tr["device_by_name"][:10]],
            "idle_gaps": tr["idle_gaps"][:10]}
    res["info"] = dict(
        seed=seed, setup=setup, window_s=win.seconds,
        sample_s=[s.seconds for s in win.samples],
        sample_cpu_s=[s.cpu_s for s in win.samples],
        sample_stages=[s.stages for s in win.samples],
        window_cpu=win.cpu, cpus=os.cpu_count(), counters=win.counts,
        stages=win.stages, reference_s=time.perf_counter() - t,
        reference_parts=ref.seconds, reference_reads=ref.reads,
        sites_checked=len(ref.lines))
    res["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                     for k, v in numbers.items()}
    return res


def main(argv=None) -> int:
    from . import spec

    ap = argparse.ArgumentParser(prog="python3 -m genobench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 1
    from . import harness  # noqa: F401  (the harness and the reference,
    from .reference import check  # noqa: F401  loaded before the check)

    bad = forbidden_modules()
    if bad:
        print(f"error: loaded {bad}", file=sys.stderr)
        return 1
    work = tempfile.mkdtemp(prefix="genobench-")
    try:
        res = measure(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"error: loaded {bad} by the end of the window",
              file=sys.stderr)
        return 1
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
