"""Command line of the PyTorch port (the subcommands of
``vargeno_tpu/cli.py``):

  python -m vargeno_tpu_torch.cli index  <ref.fa> <snps.vcf> <prefix>
      [--reference-format]
  python -m vargeno_tpu_torch.cli geno   <prefix> <reads.fq> <snps.vcf> <out.vcf>
      [--device cuda|cpu] [--mesh N [--sharded-dict]] [--batch-reads N]
      [--no-stride-bug]
      [--checkpoint PATH] [--limit-batches N] [--metrics PATH]
      [--trace-dir DIR]
      [--no-auto-tune] [--inline-dual] [capacity flags]
      [--group-size G] [--pipeline-depth N] [--no-pre-encode]
      [--multihost HOST:PORT --num-processes P --process-id I
       [--dist-backend nccl|gloo] [--local-devices DEV[,DEV...]]]
  python -m vargeno_tpu_torch.cli cohort <prefix> <snps.vcf> <out_{sample}.vcf>
      name=reads.fq [name=reads.fq ...] [--device cuda|cpu] [--mesh N]
  python -m vargeno_tpu_torch.cli oracle-geno <prefix> <reads.fq> <snps.vcf> <out.vcf>
  python -m vargeno_tpu_torch.cli kmerc  <ref.fa>
  python -m vargeno_tpu_torch.cli filt   <prefix> <out_prefix>
  python -m vargeno_tpu_torch.cli vcfd | vcfbf | ucscd | ucscbf | encodebf | help
  python -m vargeno_tpu_torch.cli genotype ...   (the reference's no-op)

``geno`` and ``cohort`` run on the GPU by default and stop with an error
when there is none; the host runs them only with ``--device cpu``. ``--mesh
N`` runs on GPUs 0 .. N-1 and stops with an error when fewer are visible;
with ``--device cpu`` its N shards all run on the host. The index-side
subcommands, ``oracle-geno`` and ``kmerc`` are host code.

``geno`` keeps ``--pipeline-depth`` batches in flight (default 2, as the
JAX package), each synced by a fetch worker thread; ``--group-size G``
issues G pre-encoded sub-batches a dispatch; ``--no-pre-encode`` ships base
codes that the step encodes on the device (a mesh always ships encoded
words). Results are the same at every setting.

``geno --multihost`` is one process of a multi-process run: start the same
command once for every process id 0 .. P-1. ``--mesh D`` is then the global
shard count (default: P times the local devices named, or P) and must
divide by P; each process drives D / P shards on its ``--local-devices``
(default: process p takes D/P consecutive cards from cuda:(p * D/P mod n)
of the n visible, so the processes of one host share its cards out and a
process that is alone on its host starts at cuda:0; or the host with
``--device cpu``). The data
collectives go over ``--dist-backend`` (default nccl with cuda, gloo with
cpu; NCCL takes one process a card, so a card named by two processes needs
gloo). Every collective waits at most 300 s for a peer. Only process 0
writes the VCF and the checkpoint.

``geno --metrics PATH`` appends one json line once the VCF is written:
reads, batches, seconds and reads/s up to the VCF closed, ``stages``, the
host loop's seconds by stage (``vcf_calls`` and ``vcf_write`` included),
and ``n_vcf_native`` / ``n_vcf_fallback``, the VCF rewrites made by the
native pass and by the Python loop (which runs where the native library
is missing or the pass declines an input). ``geno --trace-dir DIR`` runs
the stream and the VCF under ``torch.profiler`` and writes
``DIR/trace.json`` (``trace.rank<r>.json`` for each process under
``--multihost``): every thread's ``stage.*`` spans and the step's
``step.*`` spans beside the card's kernels and copies.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from .errors import InputError


def _add_engine_flags(p):
    p.add_argument("--device", default="cuda",
                   help="torch device for the batch step (default cuda; "
                        "cpu must be asked for)")
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel over N devices: GPUs 0..N-1, or N "
                        "host shards with --device cpu (0 = one device)")
    p.add_argument("--batch-reads", type=int, default=32768,
                   help="reads per device batch")
    p.add_argument("--max-read-len", type=int, default=None,
                   help="padded read length (default: auto-sized from a "
                        "FASTQ peek, 128..992)")
    p.add_argument("--no-stride-bug", action="store_true",
                   help="disable replication of the reference's small-block "
                        "scan pointer bug (qv.cc:359) - 'intended' behavior")
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
    g.add_argument("--no-auto-tune", action="store_true",
                   help="disable runtime capacity auto-tuning (by default "
                        "lane capacities shrink to measured maxima after a "
                        "few batches)")
    h = p.add_argument_group("host dispatch pipeline")
    h.add_argument("--group-size", type=int, default=None,
                   help="sub-batches scanned per device dispatch "
                        "(amortizes dispatch-link latency)")
    h.add_argument("--pipeline-depth", type=int, default=None,
                   help="in-flight dispatches kept by the host loop")
    h.add_argument("--no-pre-encode", action="store_true",
                   help="ship raw base codes instead of host-packed "
                        "kmer words")


def _config(args, fastqs):
    from .config import GenoConfig

    L = args.max_read_len
    if L is None:   # auto-size so long reads are never truncated
        from .io.fastq import autosize_shapes

        shapes = [autosize_shapes(fq) for fq in fastqs]
        L = max(s[0] for s in shapes)
        K = max(s[1] for s in shapes)
    else:
        K = max(1, L // 32)
    kw = dict(batch_reads=args.batch_reads, max_read_len=L,
              max_kmers_per_read=K, auto_tune=not args.no_auto_tune,
              replicate_stride_bug=not args.no_stride_bug)
    for f in ("events_per_read", "candidates_per_read", "neighbor_item_frac",
              "probe_hit_cap", "agree_cap", "scan_slot_cap",
              "auto_retry_max", "group_size", "pipeline_depth"):
        v = getattr(args, f)
        if v is not None:
            kw[f] = v
    if args.no_pre_encode:
        kw["pre_encode"] = False
    return GenoConfig(**kw)


def _process_layout(args):
    """(local devices, data backend) of one process of a ``--multihost``
    run; ValueError for a layout that cannot run."""
    import torch

    if not args.multihost:
        raise ValueError("--num-processes, --process-id, --dist-backend and "
                         "--local-devices need --multihost")
    P = args.num_processes
    if P < 1 or not 0 <= args.process_id < P:
        raise ValueError(f"--process-id {args.process_id} is outside "
                         f"0 .. {P - 1}")
    kind = torch.device(args.device).type
    named = args.local_devices.split(",") if args.local_devices else None
    D = args.mesh or P * (len(named) if named else 1)
    if D % P:
        raise ValueError(f"a mesh of {D} shards is not divisible by {P} "
                         f"processes")
    local_D = D // P
    if named is None:
        if kind == "cpu":
            named = ["cpu"] * local_D
        else:
            n = torch.cuda.device_count()
            first = (args.process_id * local_D) % max(n, 1)
            if first + local_D > n:
                raise ValueError(f"process {args.process_id} takes cards "
                                 f"{first} .. {first + local_D - 1} but {n} "
                                 f"CUDA device(s) are visible (name "
                                 f"--local-devices to repeat one)")
            named = [f"cuda:{first + i}" for i in range(local_D)]
    elif len(named) != local_D:
        raise ValueError(f"{len(named)} --local-devices named for {local_D} "
                         f"shards a process")
    if any(torch.device(d).type != kind for d in named):
        raise ValueError(f"--local-devices must be {kind} devices with "
                         f"--device {args.device}")
    backend = args.dist_backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("--dist-backend nccl needs --device cuda")
    return named, backend


def main(argv=None):
    try:
        return _main(argv)
    except InputError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _parser():
    ap = argparse.ArgumentParser(prog="vargeno-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("index", help="build dictionaries + Bloom filters")
    p.add_argument("ref_fasta")
    p.add_argument("snp_vcf")
    p.add_argument("prefix")
    p.add_argument("--reference-format", action="store_true",
                   help="also write the reference's .dict/.bf binary formats")

    p = sub.add_parser("geno", help="genotype reads")
    p.add_argument("prefix")
    p.add_argument("reads_fq")
    p.add_argument("snp_vcf")
    p.add_argument("out_vcf")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path for resumable runs")
    p.add_argument("--limit-batches", type=int, default=None,
                   help="stop after N host-loop batches (checkpoint "
                        "testing / partial runs)")
    p.add_argument("--metrics", default=None,
                   help="append jsonl throughput metrics (with the seconds "
                        "by stage and the VCF rewrite's path) to this path")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                        "to DIR/trace.json (trace.rank<r>.json a process "
                        "under --multihost)")
    p.add_argument("--inline-dual", "--mh-inline-dual", dest="inline_dual",
                   action="store_true",
                   help="forward+reverse of every batch in one step (2x "
                        "device work) instead of the default queued retry "
                        "of failed reads (lockstep across processes with "
                        "--multihost); results are bit-identical")
    p.add_argument("--sharded-dict", action="store_true",
                   help="with --mesh or --multihost: partition the "
                        "dictionaries across the mesh (all-to-all routed "
                        "probes, no hash table)")
    m = p.add_argument_group("multi-process (torch.distributed; run the "
                             "same command for every process id)")
    m.add_argument("--multihost", default=None, metavar="HOST:PORT",
                   help="process 0's address: this is one process of a "
                        "multi-process run")
    m.add_argument("--num-processes", type=int, default=1)
    m.add_argument("--process-id", type=int, default=0)
    m.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="backend of the data collectives (default nccl "
                        "with --device cuda, gloo with --device cpu)")
    m.add_argument("--local-devices", default=None, metavar="DEV[,DEV...]",
                   help="this process's shard devices, one a shard "
                        "(default D/P consecutive cards from cuda:(I * D/P "
                        "mod the visible count); a device repeats only "
                        "where named)")
    _add_engine_flags(p)

    p = sub.add_parser("cohort", help="genotype multiple samples")
    p.add_argument("prefix")
    p.add_argument("snp_vcf")
    p.add_argument("out_pattern",
                   help="per-sample output, e.g. out_{sample}.vcf")
    p.add_argument("samples", nargs="+", help="name=reads.fq pairs")
    _add_engine_flags(p)

    sub.add_parser("help", help="show this help (reference: qv.cc:1853)")

    p = sub.add_parser("vcfd", help="build dictionaries only (legacy vcfd)")
    p.add_argument("ref_fasta")
    p.add_argument("snp_vcf")
    p.add_argument("ref_dict")
    p.add_argument("snp_dict")

    p = sub.add_parser("kmerc", help="count distinct LO32/LO40 k-mer halves "
                                     "(BF sizing tool, reference kmerc)")
    p.add_argument("ref_fasta")

    p = sub.add_parser(
        "genotype",
        help="legacy 7-arg form; a NO-OP in the reference (the genotype() "
             "call is commented out, src/qv.cc:2092) - use `geno`")
    p.add_argument("legacy_args", nargs="*")

    p = sub.add_parser("oracle-geno",
                       help="run the sequential oracle engine (debug / "
                            "bit-parity reference mode)")
    p.add_argument("prefix")
    p.add_argument("reads_fq")
    p.add_argument("snp_vcf")
    p.add_argument("out_vcf")

    p = sub.add_parser("vcfbf", help="build Bloom filters only (gbf vcf)")
    p.add_argument("ref_fasta")
    p.add_argument("snp_vcf")
    p.add_argument("ref_bf")
    p.add_argument("snp_bf")

    p = sub.add_parser("ucscd", help="build dicts from UCSC SNP txt")
    p.add_argument("ref_fasta")
    p.add_argument("snp_txt")
    p.add_argument("ref_dict")
    p.add_argument("snp_dict")

    p = sub.add_parser("ucscbf", help="build Bloom filters from UCSC txt")
    p.add_argument("ref_fasta")
    p.add_argument("snp_txt")
    p.add_argument("ref_bf")
    p.add_argument("snp_bf")

    p = sub.add_parser("encodebf",
                       help="SNP Bloom filter from raw values; without "
                       "--ref-fasta this is `gbf snp`, with it `gbf encode`"
                       " (both reference:src/gbf.cc:31-66)")
    p.add_argument("encode_file")
    p.add_argument("snp_bf")
    p.add_argument("--ref-fasta", default=None,
                   help="also build the genome Bloom filter (gbf encode)")
    p.add_argument("--ref-bf", default=None,
                   help="output path for the genome BF (with --ref-fasta)")

    p = sub.add_parser("filt", help="shrink ref dict to SNP-proximal k-mers")
    p.add_argument("prefix")
    p.add_argument("out_prefix")
    return ap


def _write_dicts(args, snp_dict) -> None:
    """vcfd / ucscd: the chrlens file, the ref dict and the given snp dict
    in the reference's binary formats."""
    from .index import dictgen, store
    from .io import fasta as fasta_io

    seqs = fasta_io.parse_fasta(args.ref_fasta)
    with open(args.ref_fasta + ".chrlens", "w") as f:
        f.write(fasta_io.chrlens_text(seqs))
    ref_dict, _ = dictgen.build_ref_dict(seqs)
    store.write_snp_dict(args.snp_dict, snp_dict(seqs))
    store.write_ref_dict(args.ref_dict, ref_dict)


def _write_bfs(args, snp_bf) -> None:
    """vcfbf / ucscbf: the genome Bloom filters and the given snp one."""
    from .config import DEFAULT_CONFIG as cfg
    from .index import bloom, store
    from .io import fasta as fasta_io

    seqs = fasta_io.parse_fasta(args.ref_fasta)
    ref_bf, lite = bloom.build_ref_bfs(seqs, cfg.ref_bf_bits,
                                       cfg.ref_lite_bf_bits)
    store.write_sdsl_bf(args.ref_bf, ref_bf)
    store.write_sdsl_bf(args.ref_bf + ".lite.bf", lite)
    store.write_sdsl_bf(args.snp_bf, snp_bf(seqs, cfg.snp_bf_bits))


def _main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)

    if args.cmd == "help":
        ap.print_help()
        return 0

    if args.cmd == "index":
        from .index.build import build_index

        build_index(args.ref_fasta, args.snp_vcf, args.prefix,
                    write_reference_format=args.reference_format)
        return 0

    if args.cmd == "genotype":
        print("`genotype` is a no-op in the reference binary "
              "(src/qv.cc:2092); use `geno`.", file=sys.stderr)
        return 0

    if args.cmd in ("geno", "cohort"):
        import torch

        if torch.device(args.device).type == "cuda" \
                and not torch.cuda.is_available():
            print("error: no CUDA device is available (pass --device cpu "
                  "to run on the host)", file=sys.stderr)
            return 1
        from .index import store

        layout = None
        if args.cmd == "geno" and (
                args.multihost or args.num_processes != 1 or args.process_id
                or args.dist_backend or args.local_devices):
            try:
                layout = _process_layout(args)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
        if args.mesh < 0 or (args.cmd == "geno" and args.sharded_dict
                             and not (args.mesh or layout)):
            print("error: --mesh takes N >= 1 shards (and --sharded-dict "
                  "needs it or --multihost)", file=sys.stderr)
            return 1
        mesh = None
        if args.mesh and layout is None:
            from .dist.sharding import make_mesh

            try:
                mesh = make_mesh(args.mesh, devices=(
                    ["cpu"] * args.mesh
                    if torch.device(args.device).type == "cpu" else None))
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1

    if args.cmd == "geno":
        cluster = None
        if layout is not None:
            from .dist import multihost

            cluster = multihost.initialize(
                f"tcp://{args.multihost}", args.num_processes,
                args.process_id, layout[1])
            mesh = multihost.ProcessMesh(cluster, layout[0])
        cfg = _config(args, [args.reads_fq])
        index = store.load(args.prefix)
        kw = dict(queued_orientation=not args.inline_dual,
                  metrics_path=args.metrics)
        if cluster is not None:
            cls = (multihost.MultiHostDictGenoRunner if args.sharded_dict
                   else multihost.MultiHostGenoRunner)
            runner = cls(index, mesh, cfg, **kw)
        elif mesh is not None:
            from .dist.sharded_dict import ShardedDictGenoRunner
            from .dist.sharding import ShardedGenoRunner

            cls = (ShardedDictGenoRunner if args.sharded_dict
                   else ShardedGenoRunner)
            runner = cls(index, mesh, cfg, **kw)
        else:
            from .engine.geno import GenoRunner

            runner = GenoRunner(index, cfg, device=args.device, **kw)
        tracing = contextlib.nullcontext()
        if args.trace_dir:
            from .utils import profiling

            tracing = profiling.trace(args.trace_dir, "trace.json"
                                      if cluster is None else
                                      f"trace.rank{cluster.rank}.json")
        with tracing:
            runner.consume_fastq(args.reads_fq,
                                 checkpoint_path=args.checkpoint,
                                 limit_batches=args.limit_batches)
            runner.write_vcf(args.snp_vcf, args.out_vcf)
            if args.metrics and (cluster is None or cluster.rank == 0):
                runner.meter.emit(runner.timer.totals,
                                  n_vcf_native=runner.n_vcf_native,
                                  n_vcf_fallback=runner.n_vcf_fallback)
        if cluster is not None:
            multihost.shutdown(cluster)
        return 0

    if args.cmd == "cohort":
        from .engine.cohort import CohortRunner

        pairs = [s.split("=", 1) for s in args.samples]
        bad = [s for s, p in zip(args.samples, pairs) if len(p) != 2]
        if bad:
            print(f"error: cohort samples must be name=reads.fq, got {bad}",
                  file=sys.stderr)
            return 1
        index = store.load(args.prefix)
        runner = CohortRunner(index, [n for n, _ in pairs],
                              _config(args, [f for _, f in pairs]),
                              device=args.device, mesh=mesh)
        for name, fq in pairs:
            runner.consume_sample(name, fq)
        runner.write_vcfs(args.snp_vcf, args.out_pattern)
        return 0

    if args.cmd == "oracle-geno":
        import numpy as np

        from .finalize import finalize_calls
        from .index import store
        from .io.vcf_writer import write_calls_vcf
        from .oracle import OracleEngine

        index = store.load(args.prefix)
        eng = OracleEngine(index)
        eng.run_fastq(args.reads_fq)
        s = index.sites
        rc = np.array([eng.pileup[int(p)][4] for p in s.pos])
        ac = np.array([eng.pileup[int(p)][5] for p in s.pos])
        table = finalize_calls(index.chrlens, s.pos, s.ref, s.alt, s.rf,
                               s.af, rc, ac, eng.config)
        write_calls_vcf(args.snp_vcf, args.out_vcf, table)
        return 0

    if args.cmd == "kmerc":
        import numpy as np

        from .core.kmer import np_rolling_kmers_u64, np_window_has_n
        from .io import fasta as fasta_io

        seqs = fasta_io.parse_fasta(args.ref_fasta)
        lo32 = set()
        all40 = []
        for s in seqs:
            codes = s.codes_normalized()
            roll = np_rolling_kmers_u64(codes)
            ok = ~np_window_has_n(codes)
            k = roll[ok]
            lo32.update(np.unique(k & np.uint64(0xFFFFFFFF)).tolist())
            all40.append(np.unique(k & np.uint64(0xFF_FFFF_FFFF)))
        n40 = np.unique(np.concatenate(all40)).size if all40 else 0
        print(f"distinct LO32: {len(lo32)}")
        print(f"distinct LO40: {n40}")
        return 0

    if args.cmd == "vcfd":
        from .index import dictgen

        _write_dicts(args, lambda seqs: dictgen.build_snp_dict_from_vcf(
            seqs, args.snp_vcf)[0])
        return 0

    if args.cmd == "ucscd":
        from .index import ucsc

        _write_dicts(args, lambda seqs: ucsc.build_snp_dict_ucsc(
            seqs, args.snp_txt)[0])
        return 0

    if args.cmd == "vcfbf":
        from .index import bloom

        _write_bfs(args, lambda seqs, bits: bloom.build_snp_bf(
            seqs, args.snp_vcf, bits))
        return 0

    if args.cmd == "ucscbf":
        from .index import ucsc

        _write_bfs(args, lambda seqs, bits: ucsc.build_snp_bf_ucsc(
            seqs, args.snp_txt, bits))
        return 0

    if args.cmd == "encodebf":
        from .config import DEFAULT_CONFIG as cfg
        from .index import store, ucsc

        if args.ref_fasta:  # gbf encode: genome BF + encode snp BF
            from .index import bloom
            from .io import fasta as fasta_io

            if not args.ref_bf:
                print("encodebf: --ref-bf is required with --ref-fasta",
                      file=sys.stderr)
                return 1
            seqs = fasta_io.parse_fasta(args.ref_fasta)
            ref_bf, _ = bloom.build_ref_bfs(seqs, cfg.ref_bf_bits,
                                            cfg.ref_lite_bf_bits)
            store.write_sdsl_bf(args.ref_bf, ref_bf)
        bf = ucsc.build_snp_bf_encode(args.encode_file, cfg.snp_bf_bits)
        store.write_sdsl_bf(args.snp_bf, bf)
        return 0

    if args.cmd == "filt":
        from .index import filt

        filt.filt_prefix(args.prefix, args.out_prefix)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
