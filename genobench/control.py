"""The controls of ``correct``, at a cell's own size: the reference put in
the program's place with one guarantee of the configuration broken,
judged by the same numbers a run is judged by.

    python3 -m genobench.control --workload <cell> --seeds <n> [<n> ...]

- ``neighbors_off``: the reference without its Hamming-1 neighbour search
  of low-quality k-mers (the guarantee the configuration states; the
  step's largest part, so the shortcut a later change would be tempted
  by);
- ``float32_calls``: the reference's counts called in float32 instead of
  the configuration's float64 (the precision below it).

A number a control reads above its limit shows that the comparison tells
the control from the reference. One JSON line a seed on standard output.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np


def controls(cell, seed: int, work: str, n_sites: int | None = None) -> dict:
    from . import gen
    from .reference import check

    t0 = time.perf_counter()
    inputs = gen.make_inputs(seed, cell.config, cell.mix, work)
    g = cell.config["geno"]
    p = check.prepare(inputs.fasta, inputs.vcf, inputs.fastq,
                      int(g["ref_bf_bytes"]) * 8, int(g["snp_bf_bytes"]) * 8,
                      n_sites or check.N_SITES, seed)
    ref = check.reference(p)
    out = {"seed": seed, "sites": len(ref.lines), "reads": ref.reads,
           "neighbors_off": check.compare(ref, check.reference(
               p, neighbors=False)),
           "float32_calls": check.compare(ref, check.reference(
               p, dtype=np.float32)),
           "limits": check.LIMITS}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    from . import spec

    ap = argparse.ArgumentParser(prog="python3 -m genobench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        work = tempfile.mkdtemp(prefix="genobench-control-")
        try:
            print(json.dumps(controls(cell, seed, work)), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
