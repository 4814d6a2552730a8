"""Index-build benchmark: the port's ``index`` against the reference binary
(port of ``tools/bench_index_build.py``).

    python -m vargeno_tpu_torch.tools.bench_index_build [--dataset DIR]
        [--reps N] [--reference-format]

The reference's ``vargeno index`` (src/qv.cc:2239-2389) is half its CLI
surface: two Bloom-filter passes, the SNP and ref dictionary builds and
binary serialization. The port's is ``index/build.py`` (host code: numpy
rolling encodes and the native radix sort). This tool times
``python -m vargeno_tpu_torch.cli index`` cold (a fresh output prefix and a
fresh interpreter each rep) on the bench dataset (``tools/bench.py``'s
cache directory by default), checks that the artifacts exist, and reports
the best seconds against ``ref_index_build_s`` of ``bench_baseline.json``
(which it only reads). With the reference binary present
(``VGT_REF_BINARY``, default /tmp/refbuild/vargeno) it times that too and
records its seconds in the dataset directory's ``ref_baseline.json``. It
writes nothing into the repo. One JSON line on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

from . import bench

# the five files of the reference's binary formats (``--reference-format``)
REFERENCE_FORMAT = (".ref.dict", ".snp.dict", ".ref.bf", ".ref.bf.lite.bf",
                    ".snp.bf")


def wipe(prefix: str) -> None:
    for suf in (".vgt.npz", ".chrlens") + REFERENCE_FORMAT:
        if os.path.exists(prefix + suf):
            os.remove(prefix + suf)
    shutil.rmtree(prefix + ".vgt", ignore_errors=True)


def timed_run(cmd, cwd=None) -> float:
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, cwd=cwd, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    return time.perf_counter() - t0


def missing_artifacts(prefix: str, reference_format: bool) -> list:
    """The artifacts of ``index`` at ``prefix`` that are not there."""
    miss = [] if (os.path.isdir(prefix + ".vgt")
                  or os.path.exists(prefix + ".vgt.npz")) else [".vgt"]
    if reference_format:
        miss += [s for s in REFERENCE_FORMAT
                 if not os.path.exists(prefix + s)]
    return miss


def run(dataset: str, reps: int, reference_format: bool) -> dict:
    fa = os.path.join(dataset, "genome.fa")
    vcf = os.path.join(dataset, "snps.vcf")
    if not os.path.exists(fa):
        raise FileNotFoundError(f"dataset not found: {fa} (run python -m "
                                f"vargeno_tpu_torch.tools.bench once to "
                                f"make it)")
    out = {"dataset": dataset, "genome_bytes": os.path.getsize(fa),
           "vcf_bytes": os.path.getsize(vcf)}

    # the port: a cold interpreter each rep; the best rep is the steady
    # machine
    prefix = os.path.join(dataset, "ibench")
    cmd = [sys.executable, "-m", "vargeno_tpu_torch.cli", "index", fa, vcf,
           prefix] + (["--reference-format"] if reference_format else [])
    ts = []
    for _ in range(reps):
        wipe(prefix)
        ts.append(timed_run(cmd, cwd=bench.REPO))
    out["ours_s"] = round(min(ts), 2)
    out["ours_all_s"] = [round(t, 2) for t in ts]
    miss = missing_artifacts(prefix, reference_format)
    if miss:
        raise RuntimeError(f"the index build left no {miss} at {prefix}")
    rb = bench.ref_index_build_s()
    out["ref_index_build_s"] = rb
    out["index_build_vs"] = round(rb / out["ours_s"], 2) if rb else None

    binary = bench.ref_binary()
    if os.path.exists(binary):
        ref_prefix = os.path.join(dataset, "ibench_ref")
        ts = []
        for _ in range(reps):
            wipe(ref_prefix)
            ts.append(timed_run([binary, "index", fa, vcf, ref_prefix]))
        out["ref_s"] = round(min(ts), 2)
        out["ref_all_s"] = [round(t, 2) for t in ts]
        out["speedup_vs_ref"] = round(out["ref_s"] / out["ours_s"], 2)
        bench.update_json(os.path.join(dataset, "ref_baseline.json"),
                           {"ref_index_build_s": out["ref_s"],
                            "ref_index_dataset_bytes": out["genome_bytes"]})
    else:
        print(f"# reference binary not found at {binary}; skipping the "
              f"comparison leg", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.bench_index_build",
        description="cold index-build seconds of the port")
    ap.add_argument("--dataset", default=None,
                    help="directory holding genome.fa and snps.vcf "
                         "(default: the bench's cache directory)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--reference-format", action="store_true",
                    help="also write the reference's binary formats (the "
                         "like-for-like configuration)")
    args = ap.parse_args(argv)
    dataset = args.dataset or bench.Workload.from_env().cache
    print(json.dumps(run(dataset, args.reps, args.reference_format)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
