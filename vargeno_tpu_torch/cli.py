"""Command line of the PyTorch port (the ``index`` and ``geno`` subcommands
of ``vargeno_tpu/cli.py``):

  python -m vargeno_tpu_torch.cli index <ref.fa> <snps.vcf> <prefix>
  python -m vargeno_tpu_torch.cli geno  <prefix> <reads.fq> <snps.vcf> <out.vcf>
      [--device cuda|cpu] [--batch-reads N] [capacity flags]

``geno`` runs on the GPU by default and stops with an error when there is
none; the host runs it only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

from .errors import InputError


def _config(args):
    from .config import GenoConfig

    L = args.max_read_len
    if L is None:   # auto-size so long reads are never truncated
        from .io.fastq import autosize_shapes

        L, K = autosize_shapes(args.reads_fq)
    else:
        K = max(1, L // 32)
    kw = dict(batch_reads=args.batch_reads, max_read_len=L,
              max_kmers_per_read=K)
    for f in ("events_per_read", "candidates_per_read", "neighbor_item_frac",
              "probe_hit_cap", "agree_cap", "scan_slot_cap",
              "auto_retry_max"):
        v = getattr(args, f)
        if v is not None:
            kw[f] = v
    return GenoConfig(**kw)


def main(argv=None):
    try:
        return _main(argv)
    except InputError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _main(argv=None):
    ap = argparse.ArgumentParser(prog="vargeno-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("index", help="build dictionaries + Bloom filters")
    p.add_argument("ref_fasta")
    p.add_argument("snp_vcf")
    p.add_argument("prefix")

    p = sub.add_parser("geno", help="genotype reads")
    p.add_argument("prefix")
    p.add_argument("reads_fq")
    p.add_argument("snp_vcf")
    p.add_argument("out_vcf")
    p.add_argument("--device", default="cuda",
                   help="torch device for the batch step (default cuda; "
                        "cpu must be asked for)")
    p.add_argument("--batch-reads", type=int, default=32768,
                   help="reads per device batch")
    p.add_argument("--max-read-len", type=int, default=None,
                   help="padded read length (default: auto-sized from a "
                        "FASTQ peek, 128..992)")
    g = p.add_argument_group("engine capacities (doubled and the batch "
                             "redone on overflow; see --auto-retry-max)")
    g.add_argument("--events-per-read", type=int, default=None)
    g.add_argument("--candidates-per-read", type=int, default=None)
    g.add_argument("--neighbor-item-frac", type=float, default=None)
    g.add_argument("--probe-hit-cap", type=int, default=None)
    g.add_argument("--agree-cap", type=int, default=None)
    g.add_argument("--scan-slot-cap", type=int, default=None)
    g.add_argument("--auto-retry-max", type=int, default=None,
                   help="max per-batch cap-doubling rounds (0 disables)")

    args = ap.parse_args(argv)

    if args.cmd == "index":
        from .index.build import build_index

        build_index(args.ref_fasta, args.snp_vcf, args.prefix)
        return 0

    import torch

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("error: no CUDA device is available (pass --device cpu to "
              "run on the host)", file=sys.stderr)
        return 1
    from .engine.geno import GenoRunner
    from .index import store

    cfg = _config(args)
    index = store.load(args.prefix)
    runner = GenoRunner(index, cfg, device=args.device)
    runner.consume_fastq(args.reads_fq)
    runner.write_vcf(args.snp_vcf, args.out_vcf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
