#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR | --all-cards
                           | --wgs [--repeats | --filt]
                           | --wgs-cards [--repeats] | --all-cards --wgs-cards]

``--all-cards`` runs only the build and phase ``cards`` (below) on every
visible card (2 or more). ``--wgs`` runs only the build and phase ``wgs``
(below): the whole genome on one card; ``--wgs --filt`` runs the build
and phase ``wgs_filt`` (below) instead. ``--wgs-cards`` (four visible cards;
refused otherwise) runs the build, then phase ``wgs_cards`` (below): the
whole genome with a shard a card; beside its synthesis and index build run
phases 3, 4 and 13 and, with ``--all-cards`` too, phase ``cards`` (whose
reads/s are then taken beside that host build). A failed phase of that mode
is recorded and the others still run; the run then exits 1. ``--repeats``
(with ``--wgs`` or ``--wgs-cards`` only) draws that whole genome
repeat-rich: the same seed and sizes with REPEATS_DUP_SHARE of its bases in
segment families (``rehearse_wgs --dup-share``), in a cache directory of
its own; the phase then also requires that the first attempt of its
one-process stream spilled the ambiguous-exact capacity, and prints the
index's aux rows and each card's ``aux_all`` bytes.

``--parent DIR`` names a checkout of an earlier commit of this repository,
unpacked into a directory inside this one (``git archive <commit> | tar -x
-C .parent``, say): the real phase then profiles one forward step of that
checkout's package too (device operations, time on the card, the vote
kernel's own time there and on the kernel phase's random streams) and times
its (E, B) vote entry, each checkout in a process of its own, and prints
both side by side. Without it the run shows nothing of the parent, and the
vote's ``ms_before`` on the kernels line is null.

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device  -- require CUDA; print the card's name and power limit (as
   nvidia-smi reports them) and the torch / CUDA / numpy versions.
2. build   -- compile both kernels (nvcc, sm_90a) and the native host
   library (g++) from the sources in this checkout; print the seconds and
   ptxas' register lines.
3. kernel  -- each hand-written kernel against its plain PyTorch version on
   the card, exact equality (integers), median times of both from CUDA
   events, and the least time the card could take for the same work.
   The vote kernel on random event streams with ragged per-read counts,
   packed as the step packs them ((B, E) views of (B, E + 1)-strided int64
   records), at (E, B, C) = (96, 32768, 32), (96, 32768, 64), (8, 32768,
   32) (the auto-tuned shape), (32, 4096, 16), and at the wide tables that
   overflow escalation reaches, (1200, 4096, 1024) and (2000, 1024, 520)
   (global-workspace table); (32, 4096, 16) and (2000, 1024, 520) must
   overflow their candidate tables. Both entries (records, and the (E, B)
   layout) against both plain versions. Timed apart: the bare launch on
   pre-built records, the records entry, the (E, B) entry. The
   row-gather kernel at (N, R, W) = (65536, 2097152, 32) (the shape of the
   TPU kernel it replaces), (4194304, 2097152, 32), (524288, 524288, 128),
   with every index equal, with N = 1, and on a permutation index (N = R
   distinct rows of 128 B and of 512 B: the card's rate on random rows);
   the wrapper, which launches the ring kernel for many 128 B rows and the
   direct-load kernel for the rest, beside each kernel named outright, and
   both kernels over N = 2**16 .. 2**22 at 128 B rows (where the choice
   between them should lie).
4. bench   -- the gather-rate bench (tools/bench_gather.py) on the card at
   its full table size: the main path of the row-gather kernel, whose
   launches are counted here. Prints its JSON line.
5. golden  -- index the mini fixture and genotype it on the card at
   batch_reads=512: at default capacities; with 640 events and 1024
   candidates a read; with both orientations inline (non-queued); with
   auto-tune on (it must fire); stopped after 8 batches with a checkpoint
   every 4 and resumed by a second runner; as the first sample of a
   two-sample cohort (whose second sample stops after 2 batches and must
   differ); the long-read fixture (101 to 992 bases) at the shapes the CLI
   picks from a FASTQ peek, against golden_long_output.vcf. Each VCF must
   be byte-identical to the reference binary's golden output, with the
   vote kernel launched and no capacity overflow left after escalation.
   Then the filt index: its geno VCF must equal golden_filt_output.vcf.
6. mesh   -- both multi-device runners on the mini fixture, golden each
   time: the replicated-index mesh and the sharded dictionary at D = 1 and
   D = 2 (D = 2 names cuda:0 twice: it checks the routing and lockstep on
   one card and is not a deployment), the routed one from route_factor
   0.05 (must escalate), cohort on D = 2, and a single-device checkpoint
   resumed on the D = 2 sharded dictionary.
7. real    -- the benchmark workload (one 48 Mb chromosome, 500,000 SNPs,
   262,144 101 bp reads at err_frac=0.15, seed 20260817) at
   batch_reads=32768 and ht_target_load=0.24. This is the main path of
   the vote kernel, whose launches are counted here. Prints index build /
   load seconds, end-to-end reads/s (index load excluded), peak device
   memory and the run's counters; the roofline report of that pass from
   its reads/s, its measured retry fraction and the bench phase's rates; a
   second pass with auto-tune on (reads/s of both, the tuned capacities,
   equal pileup counts required); the first two batches are re-run with
   the plain vote and must give the same counts; the bare vote launch is
   timed on the first batch's own records; the device operations of one
   vote call (at most 3) and of one forward step are counted with
   torch.profiler, the step in a process of its own, with the vote
   kernel's own time there.
8. geno_bench -- the port's measurement entry points, each a user's
   command line (``python -m vargeno_tpu_torch.tools.<tool>``) in a process
   of its own on the real phase's dataset and index (nothing built again),
   alone on the card: ``bench`` (reads/s as the median of clean passes
   bracketed by device-rate probes, the dispatch mode calibrated, the
   bench phase's gather rates handed over through its cache; its JSON
   line is printed with the card's name and power limit; at least 5
   passes, no overflow, the vote kernel launched, both roofline fractions
   in (0, 1.05]) and ``bench_cohort --donors 8``. The bench's and every
   donor's counts must equal the real phase's at every site.
9. routed -- the same workload, untuned, through the sharded-dictionary
   runner at D = 1 and D = 2 once the hash-table index is freed: counts
   equal to the hash-table pass's, no overflow, the vote kernel launched;
   reads/s, escalations, route_overflow, peak device memory, the index's
   device bytes; the device operations of one routed forward step (own
   process); the oracle spot check (2,048 reads through the sequential
   oracle and the D = 1 runner, all 500,000 sites' counts equal).
10. multihost -- multi-process geno (dist/multihost.py), each process a
   fresh interpreter (``--mh-worker``), each cluster under its own time
   limit: the mini runs (data-parallel queued, inline dual, sharded
   dictionary, forced escalation, a checkpoint stop) on 2 processes naming
   cuda:0 over gloo and on 1 process over nccl, golden each, the 2-process
   checkpoint resumed by a single-process runner; then the 48 Mb workload
   through the 2-process sharded dictionary on cuda:0 over gloo, its VCF
   equal to the hash-table pass's; vote launches, peak device memory and
   index bytes per process. Two processes on one card check the protocol
   and a shard's memory; they are not a deployment.
11. fuzz  -- the differential fuzzer (tools/fuzz_diff.py) on seeds fixed
   in advance: seeds 0-23 through GenoRunner as each seed's draw says, and
   the same fixtures through the replicated mesh at D = 2 and the sharded
   dictionary at D = 1 and D = 2; seeds 0 and 1 on 2 processes x 1 shard
   over gloo (replicated and sharded dictionary); seed 0 at VGT_FUZZ_BIG
   scale (307,000 reads) through the tool's command line in a process of
   its own, beside the rest. Each run's counts must equal the sequential
   oracle's at every site, with no overflow left and the vote kernel
   launched. Prints a line a runner (seeds, mismatches, escalations, vote
   launches, seconds) and the phase's seconds.
12. genome -- genome scale: a 300 Mb genome, 3,000,000 SNPs, 262,144 reads
   of 101 bp at batch_reads=32768 (the JAX package's mid-scale point).
   (a) synthesis and the index build (tools/rehearse_wgs.py, host-only;
   the bucketed ref-dictionary build) and (e) the kill / resume endurance
   over 2,097,152 more reads (tools/endurance_wgs.py: three fresh
   interpreters on the sharded dictionary at D = 1, leg B SIGKILLed at a
   checkpoint past half the stream, leg C's VCF byte-identical to leg A's)
   run in a session of their own beside phases 5, 6 and 11, (e) only once
   phases 3 and 4 are over; then (b) the hash-table runner (host
   derivation of its 34 GB table, upload, reads/s, peak device memory,
   index bytes, the bare vote launch on a 300 Mb step's records), (c) the
   sharded dictionary at D = 1, placed streamed (chunks of the
   memory-mapped rows carried straight into the shard's tensors), its
   counts equal to (b)'s at every site, and (d) the oracle spot check
   (2,048 sampled reads through the D = 1 runner and the sequential
   oracle, every site equal). No overflow may be left and the vote kernel
   must launch in every run. Each stage's peak host RSS is logged: the
   tools' stages (synthesis, build; each leg's load, placement, stream,
   VCF) from their JSON lines, and here the derivation and upload of (b)
   and the placement of (c) (``rehearse_wgs.stage_rss``: the largest RSS
   sampled every 10 ms through the stage).

13. scaling -- the scaling tools on one card, as checks of their paths
   (no scaling number; in the default run it runs while phase 11's big
   seed finishes on the card): ``python -m vargeno_tpu_torch.tools.bench_scaling
   --devices 1``; the tool's ``run_point`` at D = 2 naming cuda:0 twice,
   both modes, on its synthetic draw (2 Mb, 5,000 SNPs, 8 batches of
   2,048 reads a shard); ``python -m
   vargeno_tpu_torch.tools.bench_scaling_mh --procs 2 --devices-per-proc
   1`` naming cuda:0 for both processes over gloo (NCCL refuses a card
   shared by two processes; the tool's own default is nccl). Every point:
   no overflow left, the vote kernel launched in each process, the timed
   window's reads the tool's batches. Prints the phase's seconds.

14. repeats -- exactness on a repeat-rich genome: bench.py's widths (48
   Mb, 500,000 SNPs, 262,144 reads of 101 bp at 15 % errors) on a genome
   from ``testing.synth_repeat_genome`` with 30 % of its bases in families
   of 2-10 copies (1 % substitutions a copy) and one 16-copy family, at
   batch_reads 32768 and the real phase's default capacities, where the
   ambiguous-exact capacity (``amb_hits_per_read`` 0.25) must spill.
   Its dataset, index (the reference's Bloom geometry) and the sequential
   oracle (fork-parallel; over the first 65,536 reads, then the rest) are
   made in a process of their own beside phases 3-6, 11 and 13. GenoRunner
   queued and inline dual, the same queued with ``auto_retry_max=0`` (it
   must leave ``amb_overflow`` in its totals and the runner's warning),
   the sharded dictionary at D = 1 and D = 2 (cuda:0 twice), and 2
   processes x 1 shard on cuda:0 over gloo (``--mh-worker``; replicated
   and sharded dictionary) on the first 65,536 reads. Each run: the
   ambiguous exact hits a read of its first batch, its first attempt's
   ``amb_overflow``, escalations, the final ``amb_hits_per_read``,
   overflow left, oracle mismatches (``tools/fuzz_diff.bad_sites``),
   reads/s with the escalation redos, vote launches (count set to 0 just
   before, read just after). The queued run's first attempt must spill;
   every run but the one without retry must end with no overflow and 0
   mismatches; the four single-card VCFs must be byte-identical; the vote
   kernel must launch in every run and process.

15. pipeline -- the host dispatch pipeline (``engine/geno.py``: batches in
   flight behind the fetch worker, chained totals that rewind on
   escalation, grouped dispatch, the codes path) on phase 7's workload
   and index, untuned. GenoRunner at (pipeline_depth, group_size,
   pre_encode) = (1, 1, T), (2, 1, T), (3, 1, T), (2, 2, T), (2, 4, T),
   (1, 1, F): a warm run of 2 x G batches, then ``PIPELINE_PASSES`` timed
   passes from fresh counts; each point's VCF byte-identical to the
   (1, 1, T) point's, no overflow left, the vote kernel launched (count
   set to 0 just before the passes, read just after). Prints each point's
   reads/s (median of its passes), retry batches, escalations, rewinds,
   vote launches and the main thread's seconds a pass in ``read_batch``,
   ``dispatch``, ``finalize_wait`` and ``enqueue_retry``. Then: a forced
   escalation at depth 3 (``events_per_read`` 8 and ``agree_cap`` 1, which
   the workload's ~3 agreeing contexts a read must trip): the same VCF, at
   least one rewind of a later in-flight batch; the pinned buffers at
   depth 3 in groups of 2: every finalized handle's stats row and masks
   equal to a depth-1 rerun of its own batch (a staging buffer shared
   between handles would return another batch's row); whether
   ``torch.cuda.Event.synchronize`` releases the GIL (a thread waits on an
   event behind a sleep kernel of ~0.2 s while this thread counts); the
   sharded dictionary at D = 2 (cuda:0 twice), depth 2, groups of 2: the
   same VCF; 2 processes x 1 shard on cuda:0 over gloo (``--mh-worker``,
   sharded dictionary) on the first 65,536 reads at depth 2 and at depth
   1: the same VCF; and ``python -m vargeno_tpu_torch.tools.
   tune_host_pipeline quick --passes 1``: its JSON line.

Phase order: 1, 2, then 3-6, 11 and 13 (13 beside 11's big seed) beside
genome (a) and (e) and beside the making of phase 7's and phase 14's
datasets and indexes (a process each, host only), then 7, 15, 8-10,
genome (b)-(d) and 14; phases
7-10 and 15 never run beside those processes, so their reads/s stays
comparable with earlier runs. The log gives each phase's seconds. A JSON
line ``{"mesh": ...}`` carries phase 9's and phase 10's numbers,
``{"geno_bench": ...}`` phase 8's, ``{"fuzz": ...}`` phase 11's,
``{"scaling": ...}`` phase 13's, ``{"genome": ...}`` phase 12's,
``{"repeats": ...}`` phase 14's, ``{"pipeline": ...}`` phase 15's. Every
runner of every phase runs at the default ``pipeline_depth`` 2 unless a
phase names another.

wgs (``--wgs`` only) -- the JAX package's headline scale
   (docs/WORKFLOWS.md:62-110; hg19 + dbSNP-common): a 3,000 Mb genome,
   5,000,000 SNPs, 262,144 reads of 101 bp at batch_reads=32768, the
   rehearsal tool's generator draws (seed 20260819). (a) Synthesis and the
   bucketed index build (tools/rehearse_wgs.py ``--phase index``, its own
   process); (b) the index loaded through mmap and the sharded dictionary
   placed, streamed, at D = 2 on one card (cuda:0 twice: a shard holds at
   most 2^31 rows), the reads streamed: no overflow left, the vote kernel
   launched, the bare vote launch on the first batch's own records equal
   to the plain version and timed; (c) oracle spot parity, 2,048 sampled
   reads, every one of the 5,000,000 sites equal; (d) the kill / resume
   endurance over 2,097,152 more reads at D = 2 (tools/endurance_wgs.py,
   three fresh interpreters), the resumed VCF byte-identical. Each stage's
   peak host RSS (``rehearse_wgs.stage_rss``), the index's bytes on the
   card and the peak device memory are printed,
   with the host's free disk, processor count and MemTotal; a stage whose
   peak RSS reaches MemTotal fails the phase. With ``--repeats`` the
   stream's first attempt must spill the ambiguous-exact capacity, and (b)
   prints the aux rows and ``aux_all`` bytes. Prints a ``{"wgs": ...}``
   line. Needs ~47 GB of free disk for the index and ~6 GB for the inputs
   and outputs (checked first; ``<cache>/wgs.vgt`` may link the index to
   another file system) and about 25-30 minutes.

wgs_filt (``--wgs --filt`` only) -- the paper's workflow (index, filt,
   geno; docs/WORKFLOWS.md:16-22) at phase wgs's scale and draw, on one
   card: (a) synthesis and the bucketed build as ``--wgs`` does them (no
   endurance reads); (b) ``python -m vargeno_tpu_torch.cli filt`` on that
   index into ``<cache>/wgs_filt`` (the rehearsal tool's ``--filt``, a
   process of its own; the streamed filt of index/filt.py): its seconds,
   peak RSS, kept ref rows and bytes on disk; (c) the filtered index
   mmap'd and placed at D = 1 on cuda:0, the 262,144 reads streamed at
   batch_reads 32768 with no overflow left and the vote kernel launched
   (its count set to 0 just before the stream, read just after), forward
   and retry batches (most reads fail both orientations on a filtered
   index, as in the reference), the VCF, the bare vote launch on the
   first batch's records equal to the plain version and timed, oracle
   spot parity (2,048 sampled reads against the oracle on the filtered
   index, every site equal); (d) ``geno ... --mesh 1 --sharded-dict``
   through the command line (``--cli-rank``) on the filtered index and
   the same reads, its VCF byte-identical to (c)'s, the vote launched.
   The hash table of the filtered index does not fit the card (PERF.md).
   A stage whose peak RSS reaches MemTotal fails the phase. Prints a
   ``{"wgs_filt": ...}`` line. Needs phase wgs's disk for the index,
   inputs and outputs, and ~18 GB more beside the inputs for the filtered
   index (checked first), and about 22 minutes.

cards (``--all-cards`` only) -- the 48 Mb workload, untuned, two passes a
   runner (the second warm), every VCF equal to the one-card hash-table
   pass's: one process driving every card (replicated index: the shard
   steps in turn from one thread; sharded dictionary: a thread a shard)
   against one process a card (replicated index over nccl; sharded
   dictionary over nccl and over gloo). Then the scaling tools on bench.py's
   genome and SNPs with enough reads for 17 global batches of 32,768 reads
   a card at the largest D (2,228,224 reads on four cards), a cache of its
   own: ``bench_scaling``'s ``run_point`` at D = 1, 2, 4 (routed from 2),
   ``bench_scaling_mh``'s clusters over nccl at n x 1 and n / 2 x 2
   processes x cards, both modes, 16 global batches a point; each point's
   reads/s, efficiency (a single-process point against its mode's first
   point, as the JAX tool takes it; a multi-process point against one
   card's dp rate), every card's peak device memory and every process's
   vote launches; no overflow, the vote kernel launched in every process.
   The scaling workload is made beside the passes above. Then n processes
   of one card over nccl through the command line (the sharded dictionary
   on the 262,144 reads, as phase wgs_cards (c) runs it), the VCF equal
   to the one-card pass's, and a kill / resume across n processes over
   the scaling workload's reads (as phase wgs_cards (d), a checkpoint
   every 2 global batches). Prints a ``{"cards": ...}`` line.

wgs_cards (``--wgs-cards`` only) -- the headline scale of phase wgs (same
   generator, seed, 3,000 Mb, 5,000,000 SNPs, 262,144 reads) with a shard a
   card on cuda:0-3: (a) synthesis and the bucketed build as ``--wgs`` does
   them; (b) one process, the sharded dictionary at D = 4 over cuda:0-3:
   the reads streamed at batch_reads 32768 with no overflow left and the
   vote kernel launched, the first attempt's ambiguous exact hits a read
   and ``amb_overflow``, the VCF, the bare vote launch on the first batch's
   own records equal to the plain version and timed, oracle spot parity
   (2,048 sampled reads, every site equal); (c) four processes of one card
   over nccl through the command line (``python -m vargeno_tpu_torch.cli
   geno ... --multihost HOST:PORT --num-processes 4 --process-id i
   --dist-backend nccl --mesh 4 --sharded-dict --batch-reads 32768``, each
   in ``--cli-rank``, which runs the CLI's ``main`` on that argument list
   and times its stages), the VCF byte-identical to (b)'s; (d) kill /
   resume over the 2,097,152 endurance reads, four processes over nccl from
   ``--mh-worker`` specs (the CLI checkpoints every 64 batches and a
   32,768-read batch would checkpoint only at the end): leg A
   uninterrupted, leg B checkpointing every 4 global batches (524,288
   reads) and SIGKILLed, every rank, once a checkpoint at or past 1,048,576
   reads is on disk, leg C the same cluster again, resumed: its VCF
   byte-identical to leg A's. The escalations of every rank of (c) and of
   each leg of (d) must be equal (escalation runs in lockstep). Prints each
   stage's seconds (placement per rank, stream, spot parity, each leg), the
   index's ref and SNP aux rows, per card the index bytes, ``aux_all``
   bytes and peak device memory, per rank the host peak RSS, escalations
   and vote launches, the host's free disk, processors and MemTotal; a
   stage whose peak RSS reaches MemTotal fails the phase. Prints a
   ``{"wgs_cards": ...}`` line. Needs the disk and time of ``--wgs`` and
   four cards. With ``--repeats`` (the cache directory's name ends in
   ``_dup0.3``) (b)'s first attempt must spill.

The last two lines of the default run and of ``--wgs-cards`` are a JSON
object describing each kernel and the result line ``{"ok": true,
"device": {...}}``; the other modes end in the result line. The datasets
and indexes are cached under ``.smoke_cache/`` next to this file.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures", "mini")
CACHE = os.path.join(ROOT, ".smoke_cache")

# bench.py's workload (its read length, error fraction and seed are those
# of vargeno_tpu_torch/tools/bench.py, which makes the dataset)
GENOME_MB, N_SNPS, N_READS, BATCH, HT_LOAD = 48, 500_000, 262_144, 32768, 0.24
GENO_BENCH_DONORS = 8   # phase geno_bench's cohort
# (E, B, C, must overflow); the first is the main path's default shape
KERNEL_SHAPES = [(96, 32768, 32, False), (96, 32768, 64, False),
                 (8, 32768, 32, False), (32, 4096, 16, True),
                 (1200, 4096, 1024, False), (2000, 1024, 520, True)]
VOTE_TIMED = [(96, 32768, 32), (96, 32768, 64), (8, 32768, 32),
              (1200, 4096, 1024)]
# (N, R, W, index: "random", "same" or "perm"); the second is the one the
# kernels line times
GATHER_SHAPES = [(65536, 2097152, 32, "random"),
                 (4194304, 2097152, 32, "random"),
                 (2097152, 2097152, 32, "perm"),
                 (100000, 2097152, 32, "same"), (1, 2097152, 32, "random"),
                 (524288, 524288, 128, "random"),
                 (524288, 524288, 128, "perm")]
GATHER_MAIN = GATHER_SHAPES[1][:3]
# N of both gather kernels side by side, on the (2097152, 32) table
GATHER_CROSSOVER = [1 << p for p in range(16, 23)]
DEVICE = "cuda"
# the card's published peaks (H100 SXM data sheet): memory bytes/s, and
# operations/s outside the tensor cores (the float32 rate, taken for the
# kernels' 32-bit integer operations too)
PEAK_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12
# phase fuzz: the seeds of the differential fuzzer, fixed in advance
FUZZ_SEEDS = range(24)
FUZZ_MH_SEEDS = (0, 1)   # also on 2 processes
FUZZ_BIG_SEED = 0        # also at VGT_FUZZ_BIG scale
# phase genome: the JAX package's mid-scale point (docs/WORKFLOWS.md:56-60)
WGS_MB, WGS_SNPS, WGS_READS = 300, 3_000_000, 262_144
WGS_EXTRA_READS, WGS_SPOT = 2_097_152, 2048   # endurance stream, spot check
WGS_CHECKPOINT_EVERY = 8   # endurance checkpoints: every 262,144 reads
# --wgs: the JAX package's headline scale (docs/WORKFLOWS.md:62-110), D = 2
# shards on one card (SHARD_ROWS_MAX: at most 2^31 rows a shard)
WGS3_MB, WGS3_SNPS, WGS3_DEVICES = 3000, 5_000_000, "cuda:0,cuda:0"
# the share of that genome in segment families: 0 (uniform), or
# REPEATS_DUP_SHARE with --repeats
WGS3_DUP_SHARE = 0.0
# free bytes the index, and the inputs and outputs, need (the index may
# lie on another file system: <cache>/wgs.vgt may link to a directory)
WGS3_INDEX_DISK, WGS3_IO_DISK = 47e9, 6e9
# --wgs --filt: the paper's workflow at that scale (index, filt, geno),
# the filtered index at D = 1 on one card; the free bytes the filtered
# index (<cache>/wgs_filt.vgt, beside the inputs) needs
WGS3_FILT_DEVICES, WGS3_FILT_DISK = "cuda:0", 18e9
# phase pipeline: the (pipeline_depth, group_size, pre_encode) points, the
# first the reference of the others' VCFs; timed passes a point; the reads
# of its 2-process run
PIPELINE_POINTS = [(1, 1, True), (2, 1, True), (3, 1, True), (2, 2, True),
                   (2, 4, True), (1, 1, False)]
PIPELINE_PASSES, PIPELINE_MH_READS = 3, 65_536
PIPELINE_DEVICES = ["cuda:0", "cuda:0"]   # its D = 2 mesh and 2 processes
# phase repeats: bench.py's widths on a genome with REPEATS_DUP_SHARE of
# its bases in families of 2-10 copies (testing.synth_repeat_genome), where
# the default ambiguous-exact capacity must spill at BATCH; the 2-process
# run takes the first REPEATS_MH_READS reads
REPEATS_DUP_SHARE, REPEATS_SEED, REPEATS_MH_READS = 0.3, 20261017, 65_536
# --all-cards: batches a scaling point (32,768 reads a card each), and the
# checkpoint cadence of its kill / resume legs on the scaling workload
CARDS_SCALING_BATCHES, CARDS_CHECKPOINT_EVERY = 16, 2
# --wgs-cards: the headline scale with a shard a card on four cards, and
# the checkpoint cadence of its kill / resume legs (global batches of
# 4 x 32,768 reads)
WGS4_DEVICES, WGS4_BACKEND = "cuda:0,cuda:1,cuda:2,cuda:3", "nccl"
WGS4_CHECKPOINT_EVERY = 4


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ----------------------------------------------------------------------
def random_events(E, B, C, seed):
    """Event streams with repeating idx values (2C distinct per read, a
    few >= 2**31) and ragged counts; events past ev_n are invalid. Returns
    the (E, B) quartet with ev_n, and the same events as the step's
    records: (B, E) views of (B, E + 1)-strided int64 words whose meta
    carries ``src`` bits from bit 7 up, with the unclamped count (full
    reads count past E)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2 * C, (E, B)).astype(np.int64)
    idx[rng.random((E, B)) < 0.05] |= 1 << 31
    k = rng.integers(0, 4, (E, B)).astype(np.int32)
    isnb = rng.random((E, B)) < 0.3
    ev_n = rng.integers(0, E + 1, B).astype(np.int32)
    valid = (rng.random((E, B)) < 0.8) & (np.arange(E)[:, None]
                                          < ev_n[None, :])
    dev = torch.device("cuda")
    quartet = [torch.from_numpy(a).to(dev) for a in (idx, k, isnb, valid)]
    ev_n = torch.from_numpy(ev_n).to(dev)
    rec_idx = torch.zeros((B, E + 1), dtype=torch.int64, device=dev)
    rec_meta = torch.zeros_like(rec_idx)
    rec_idx[:, :E] = quartet[0].t()
    rec_meta[:, :E] = (quartet[1].t().long() | (quartet[2].t().long() << 5)
                       | (quartet[3].t().long() << 6)
                       | (torch.arange(B * E, device=dev).reshape(B, E) << 7))
    total = ev_n.long()
    total[total == E] += 3
    return quartet, ev_n, (rec_idx[:, :E], rec_meta[:, :E], total)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the operation rate."""
    t_b, t_o = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def device_ops(fn):
    """(n, records): the device operations (kernels, copies, memsets) that
    one call of ``fn`` puts on the card, and the (name, microseconds)
    records of device operations that torch.profiler kept. ``n`` is counted
    on the host side, from the CUDA runtime's launch, copy and memset calls
    inside the call's span, which is exact; the device-side records of a
    trace can come back incomplete, so they are handed on as found (those
    of one warm-up call inside the trace included)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function("smoke_call"):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    span = next(e for e in host if e.name == "smoke_call").time_range
    launch = re.compile(r"^cu(da)?(LaunchKernel|Memcpy|Memset)")
    n = sum(1 for e in host if launch.match(e.name)
            and span.start <= e.time_range.start <= span.end)
    if n <= 0:
        raise RuntimeError("torch.profiler recorded no device operation")
    # the span is mirrored on the device's timeline: not an operation
    records = [(e.name, e.time_range.elapsed_us()) for e in events
               if e.device_type == DeviceType.CUDA and e.name != "smoke_call"]
    return n, records


def count_device_ops(fn) -> int:
    return device_ops(fn)[0]


def kernel_us(fn, name: str, traces: int = 3):
    """Median microseconds of the device operations named ``name`` in the
    records that ``traces`` profiler traces of ``fn`` kept (two calls a
    trace), or None if none was kept: a short kernel's own time on the
    card, which neither CUDA events round one call (host launch latency)
    nor a stream of calls (the host's time to issue one) can show."""
    import statistics

    us = [t for _ in range(traces) for n, t in device_ops(fn)[1]
          if name in n]
    return statistics.median(us) if us else None


def stream_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Milliseconds a call of ``fn`` in a stream of calls: CUDA events
    round ``n`` calls in a row, over ``n``; the median of ``reps`` such
    runs. With the calls queued behind each other the host's launch
    latency, which a pair of events round one short call includes, is
    hidden, so for a bare launch this is the kernel's own time (or the
    host's time to issue a launch, if that is longer)."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def raw_vote(records, C):
    """A closure that launches the bare vote kernel on ``records`` into
    outputs allocated once, and those outputs."""
    import torch

    from vargeno_tpu_torch.kernels import vote

    ev_idx = records[0]
    B, E = ev_idx.shape
    dev = ev_idx.device
    width = max(1, min(C, E))
    process = torch.empty(B, dtype=torch.bool, device=dev)
    target = torch.empty(B, dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.int64, device=dev)
    ws = None
    if width > vote.load_library().vgt_vote_reg_max_c():
        ws = torch.empty((3, B, width), dtype=torch.int32, device=dev)

    def go():
        vote.launch_records(*records, width, process, target, ovf, ws)
    return go, (process, target, ovf)


def vote_bound(total, E, B, C):
    """The kernel loads 8 B a record (the low 32-bit word of each of its
    two int64 words; the high halves lie in the same DRAM sectors and are
    fetched with them, which the bound does not count) up to each read's
    clamped count and 8 B of count a read, and writes 9 B a read (and the
    8 B counter); an event is compared with up to min(C, E) slots and
    updates ~16 words of state."""
    n_ev = int(total.clamp(0, E).sum())
    return n_ev, bound(n_ev * 8 + B * 17 + 8, n_ev * (min(C, E) + 16))


def time_vote_on_step(phase: str, card: str, records, C) -> dict:
    """The bare vote launch on a step's own records (real reads, real
    event counts): exactly equal to the plain version, then timed between
    CUDA events round one call and in a stream of 50 launches, beside its
    bound. Prints one line; returns the numbers."""
    import torch

    from vargeno_tpu_torch.kernels.vote import vote_scan_records_plain
    from vargeno_tpu_torch.utils.profiling import device_ms

    B, E = records[0].shape
    dev = records[0].device   # a shard's card: timed on its own streams
    with torch.cuda.device(dev):
        go, raw_out = raw_vote(records, C)
        go()
        want = vote_scan_records_plain(*records, C)
        torch.cuda.synchronize(dev)
        if not all(torch.equal(a, b) for a, b in zip(raw_out, want)):
            raise AssertionError(f"{phase}: bare vote launch != plain on "
                                 f"the first batch's records")
        n_ev, (b_ms, b_by) = vote_bound(records[2], E, B, C)
        raw_ms = device_ms(go, dev, reps=20)
        st_ms = stream_ms(go)
        plain_ms = device_ms(lambda: vote_scan_records_plain(*records, C),
                             dev, reps=3)
    log(phase, f"[{card}] vote on the first forward batch's records on "
               f"{dev}, (E, B, C) = {(E, B, C)}, {n_ev} events (most in a "
               f"read {int(records[2].max())}), row stride "
               f"{records[0].stride(0)}: bare launch {raw_ms:.4f} ms "
               f"between CUDA events round one call, {st_ms:.4f} "
               f"ms a launch in a stream of 50 (no less than the host's "
               f"time to issue one), bound {b_ms:.4f} ms by {b_by}; the "
               f"plain version {plain_ms:.4f} ms")
    return dict(shape=(E, B, C), events=n_ev, raw_ms=raw_ms, stream_ms=st_ms,
                bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms)


def phase_kernel_vote():
    import torch

    from vargeno_tpu_torch.kernels.vote import (vote_scan, vote_scan_plain,
                                                vote_scan_records,
                                                vote_scan_records_plain)
    from vargeno_tpu_torch.utils.profiling import device_ms

    timing = {}
    max_err = 0
    for E, B, C, must_overflow in KERNEL_SHAPES:
        quartet, ev_n, records = random_events(E, B, C, seed=E * 1000 + C)
        if records[0].stride() != (E + 1, 1):
            raise AssertionError("the records lost their row stride")
        got = vote_scan_records(*records, C)
        via_eb = vote_scan(*quartet, C, ev_n)
        want = vote_scan_records_plain(*records, C)
        want_eb = vote_scan_plain(*quartet, C, ev_n)
        go, raw_out = raw_vote(records, C)
        go()
        torch.cuda.synchronize()
        for entry, res in (("records entry", got), ("(E, B) entry", via_eb),
                           ("bare launch", raw_out),
                           ("plain (E, B)", want_eb)):
            for name, g, w in zip(("process", "target", "cand_overflow"),
                                  res, want):
                err = int((g.long() - w.long()).abs().max())
                max_err = max(max_err, err)
                if err or g.dtype != w.dtype:
                    raise AssertionError(
                        f"vote {entry} != plain records version at "
                        f"{(E, B, C)}: {name} max err {err}, {g.dtype}")
        ovf = int(got[2])
        if must_overflow and ovf <= 0:
            raise AssertionError(f"{(E, B, C)} did not overflow")
        n_ev, (b_ms, b_by) = vote_bound(records[2], E, B, C)
        msg = (f"vote (E, B, C) = {(E, B, C)}: both entries and the bare "
               f"launch match the plain versions exactly (processed "
               f"{int(got[0].sum())}, cand_overflow {ovf})")
        if (E, B, C) in VOTE_TIMED:
            raw_ms = device_ms(go, DEVICE, reps=20)
            ms = device_ms(lambda: vote_scan_records(*records, C), DEVICE,
                           reps=20)
            eb_ms = device_ms(lambda: vote_scan(*quartet, C, ev_n), DEVICE,
                              reps=20)
            plain_ms = device_ms(
                lambda: vote_scan_records_plain(*records, C), DEVICE, reps=3)
            own_us = kernel_us(go, "vote_kernel")
            kernel_ms = stream_ms(go)
            entry_stream = stream_ms(lambda: vote_scan_records(*records, C))
            eb_stream = stream_ms(lambda: vote_scan(*quartet, C, ev_n))
            timing[E, B, C] = dict(ms=ms, kernel_ms=kernel_ms,
                                   raw_launch_ms=raw_ms, eb_entry_ms=eb_ms,
                                   plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by)
            msg += (f"; between CUDA events round one call (host launch "
                    f"latency included): bare launch {raw_ms:.4f} ms, "
                    f"records entry {ms:.4f} ms, (E, B) entry {eb_ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms; a call in a stream of 50 "
                    f"calls: bare launch (the kernel's own time) "
                    f"{kernel_ms:.4f} ms, records entry {entry_stream:.4f} "
                    f"ms, (E, B) entry {eb_stream:.4f} ms; "
                    f"bound {b_ms:.4f} ms by {b_by} for its {n_ev} events "
                    f"at 8 B loaded a record; the kernel's own record in "
                    f"a torch.profiler trace: "
                    + ("none kept" if own_us is None else f"{own_us:.1f} us"))
        log("kernel", msg)
    return timing, max_err


def phase_kernel_gather():
    import numpy as np
    import torch

    from vargeno_tpu_torch.kernels import gather
    from vargeno_tpu_torch.kernels.gather import (gather_rows_sum,
                                                  gather_rows_sum_plain)
    from vargeno_tpu_torch.utils.profiling import device_ms

    rng = np.random.default_rng(11)
    dev = torch.device(DEVICE)
    uses_ring = gather.load_library().vgt_gather_uses_ring
    timing = {}
    max_err = 0
    tables: dict = {}
    out = torch.zeros((), dtype=torch.int32, device=dev)

    def bare(idx, kernel):
        """The bare launch of the kernel named, into a zeroed word."""
        out.zero_()
        gather.launch(table, idx, out, kernel)
        return out

    for N, R, W, kind in GATHER_SHAPES:
        if (R, W) not in tables:
            tables.clear()   # one 256 MiB table on the card at a time
            tables[R, W] = torch.from_numpy(rng.integers(
                0, 2**32, (R, W), dtype=np.uint32).view(np.int32)).to(dev)
        table = tables[R, W]
        if kind == "perm":
            idx_np = rng.permutation(R).astype(np.int32)
        else:
            idx_np = rng.integers(0, R, N, dtype=np.int32)
        if kind == "same":
            idx_np[:] = idx_np[0]
        for dtype in (torch.int64, torch.int32):
            idx = torch.from_numpy(idx_np).to(dev).to(dtype)
            want = int(gather_rows_sum_plain(table, idx))
            for name, got in (("wrapper", gather_rows_sum(table, idx)),
                              ("ring", bare(idx, "ring")),
                              ("direct", bare(idx, "direct"))):
                err = abs(int(got) - want)
                max_err = max(max_err, err)
                if err:
                    raise AssertionError(
                        f"gather kernel ({name}) != plain at {(N, R, W)} "
                        f"{kind} {dtype}: {int(got)} vs {want}")
        chosen = "ring" if uses_ring(N, W) else "direct"
        ms = device_ms(lambda: gather_rows_sum(table, idx), DEVICE, reps=20)
        ring_ms = device_ms(lambda: bare(idx, "ring"), DEVICE, reps=20)
        direct_ms = device_ms(lambda: bare(idx, "direct"), DEVICE, reps=20)
        plain_ms = device_ms(lambda: gather_rows_sum_plain(table, idx),
                             DEVICE, reps=5)
        # the one PyTorch call for the same function: gather, then reduce
        lib_ms = device_ms(
            lambda: table.index_select(0, idx).sum(dtype=torch.int64),
            DEVICE, reps=5)
        # each input read once: the rows these indices name (a row named
        # twice is one row of the table, W * 4 B), 4 B an index as timed
        # (int32), 4 B out; one add a gathered word
        n_rows = int(torch.unique(idx).numel())
        b_ms, b_by = bound(n_rows * W * 4 + N * idx.element_size() + 4, N * W)
        msg = (f"gather (N, R, W) = {(N, R, W)} ({kind} index): the wrapper "
               f"(which launches the {chosen} kernel here), the ring and "
               f"the direct kernel match plain exactly (sum {want}); "
               f"between CUDA events round one call: wrapper {ms:.4f} ms, "
               f"ring {ring_ms:.4f} ms, direct {direct_ms:.4f} ms, plain "
               f"{plain_ms:.4f} ms, index_select+sum {lib_ms:.4f} ms; bound "
               f"{b_ms:.4f} ms by {b_by} for its {n_rows} distinct rows")
        if kind != "same" and N >= 1 << 19:   # the large shapes
            ring_st = stream_ms(lambda: bare(idx, "ring"), n=20)
            direct_st = stream_ms(lambda: bare(idx, "direct"), n=20)
            msg += (f"; a launch in a stream of 20: ring {ring_st:.4f} ms, "
                    f"direct {direct_st:.4f} ms")
            if kind == "perm":
                # every row distinct: the rate of random rows out of DRAM
                msg += (f"; {W * 4} B random rows at "
                        f"{N * W * 4 / (ring_st * 1e-3):.4g} B/s with the "
                        f"ring, {N * W * 4 / (direct_st * 1e-3):.4g} B/s "
                        f"direct, by the stream's time (the card's memory "
                        f"rate: {PEAK_BYTES_S:.4g} B/s)")
        if kind != "perm":
            timing[N, R, W] = dict(
                ms=ms, ms_before=direct_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                distinct_rows=n_rows, kernel=chosen)
        log("kernel", msg)
        if (N, R, W) == GATHER_MAIN:
            # both kernels over N at 128 B rows: where the choice should lie
            rows = []
            for n in GATHER_CROSSOVER:
                idx = torch.from_numpy(
                    rng.integers(0, R, n, dtype=np.int32)).to(dev)
                want = int(gather_rows_sum_plain(table, idx))
                for kernel in ("ring", "direct"):
                    if int(bare(idx, kernel)) != want:
                        raise AssertionError(
                            f"gather {kernel} kernel != plain at N = {n}")
                r1 = device_ms(lambda: bare(idx, "ring"), DEVICE, reps=20)
                d1 = device_ms(lambda: bare(idx, "direct"), DEVICE, reps=20)
                rows.append(
                    f"N = {n}: ring {r1:.4f} / "
                    f"{stream_ms(lambda: bare(idx, 'ring'), n=20):.4f}, "
                    f"direct {d1:.4f} / "
                    f"{stream_ms(lambda: bare(idx, 'direct'), n=20):.4f}, "
                    f"launched: {'ring' if uses_ring(n, W) else 'direct'}")
            log("kernel", f"gather, both kernels at R = {R}, W = {W} (ms, "
                          f"one call between CUDA events / a launch in a "
                          f"stream of 20; a zeroing of the output word is "
                          f"in each): " + "; ".join(rows))
    return timing, max_err


def phase_bench(card: str):
    """The gather-rate bench at full size: the row-gather kernel's main
    path. Returns (rates dict, kernel launches)."""
    from vargeno_tpu_torch.kernels.gather import gather_rows_sum
    from vargeno_tpu_torch.tools.bench_gather import bench

    gather_rows_sum.launches = 0
    t0 = time.perf_counter()
    rates = bench(DEVICE, verbose=False)
    launches = gather_rows_sum.launches
    if launches <= 0:
        raise AssertionError("bench: the gather kernel was never launched")
    missing = [k for k in ("word_gather_1048576", "row_gather_1048576",
                           "row_gather_512B", "kernel_row_gather",
                           "kernel_row_gather_4194304",
                           "kernel_row_gather_512B", "device_sort_u32",
                           "scatter_rows", "scatter_scalar")
               if k not in rates]
    if missing:
        raise AssertionError(f"bench: missing rates {missing}")
    log("bench", f"[{card}] {json.dumps(rates)}")
    log("bench", f"{time.perf_counter() - t0:.2f} s, gather kernel launches "
                 f"{launches}")
    return rates, launches


# ----------------------------------------------------------------------
def build_or_load_index(fa, vcf, prefix, tag):
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.index.build import build_index

    if store.exists(prefix):
        log(tag, "index found in the cache")
        return None
    t0 = time.perf_counter()
    build_index(fa, vcf, prefix)
    dt = time.perf_counter() - t0
    log(tag, f"index build {dt:.2f} s")
    return dt


def check_no_overflow(runner, tag):
    bad = {k: v for k, v in runner.stats_totals.items()
           if "overflow" in k and v}
    if bad:
        raise AssertionError(f"{tag}: overflow counters left: {bad}")


def amb_summary(runner, first: dict) -> dict:
    """What a run says of the ambiguous-exact capacity: the ambiguous
    exact hits a read of its first batch (forward pass; over every shard of
    every process), the spill of its first attempt, and the
    ``amb_hits_per_read`` it ended on."""
    reads = runner.config.batch_reads * getattr(runner, "D", 1)
    hits = first.get("amb_hits", first.get("fwd_amb_hits", 0))
    return dict(amb_hits_a_read=int(hits) / reads,
                first_amb_overflow=int(sum(
                    v for k, v in first.items()
                    if k.endswith("amb_overflow"))),
                amb_hits_per_read=runner._cfg_run.amb_hits_per_read)


def aux_rows(index) -> dict:
    """The index's aux rows: the ref dictionary's (k-mers of 2-10 genome
    positions) and the SNP dictionary's."""
    return dict(n_ref_aux=int(index.ref.aux.shape[0]),
                snp_aux_rows=int(index.snp.aux_pos.shape[0]))


def aux_bytes(runner) -> dict:
    """Bytes of ``aux_all`` on each device of a mesh runner (the table
    every shard holds whole, once a device), by device name."""
    return {str(t.device): t.numel() * t.element_size()
            for t in (runner._dix_of(s).aux_all for s in runner.shards)}


def phase_golden():
    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.engine.cohort import CohortRunner
    from vargeno_tpu_torch.engine.device_index import build_device_index
    from vargeno_tpu_torch.engine.geno import GenoRunner
    from vargeno_tpu_torch.index import filt, store
    from vargeno_tpu_torch.io.fastq import autosize_shapes
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn

    d = os.path.join(CACHE, "mini")
    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, "mini")
    fq, vcf_in = os.path.join(FIX, "reads.fq"), os.path.join(FIX, "snps.vcf")
    build_or_load_index(os.path.join(FIX, "genome.fa"), vcf_in, prefix,
                        "golden")
    index = store.load(prefix)
    base = GenoConfig(batch_reads=512, max_read_len=128,
                      max_kmers_per_read=4)
    dix = build_device_index(index, DEVICE, base.ht_target_load)
    out = os.path.join(d, "out.vcf")

    def read(name):
        with open(os.path.join(FIX, name)) as f:
            return f.read()

    def check(tag, runner, launches, dt, golden, vcf_path=out):
        with open(vcf_path) as f:
            if f.read() != golden:
                raise AssertionError(f"mini VCF ({tag}) differs from golden")
        check_no_overflow(runner, f"golden/{tag}")
        if DEVICE == "cuda" and launches <= 0:
            raise AssertionError(f"golden/{tag} never launched the vote "
                                 f"kernel")
        log("golden", f"{tag}: VCF byte-identical to golden; "
                      f"{runner.n_reads} reads in {dt:.2f} s, vote launches "
                      f"{launches}, escalations {runner.n_escalations}")

    def run(tag, cfg, golden, index=index, dix=dix, reads=fq, **runner_kw):
        runner = GenoRunner(index, cfg, device=DEVICE, dix=dix, **runner_kw)
        before = vote_fn.launches
        t0 = time.perf_counter()
        runner.consume_fastq(reads)
        runner.write_vcf(vcf_in, out)
        check(tag, runner, vote_fn.launches - before,
              time.perf_counter() - t0, golden)
        return runner

    golden = read("golden_output.vcf")
    run("default caps", base, golden)
    run("E=640 C=1024", dataclasses.replace(
        base, events_per_read=640, candidates_per_read=1024), golden)
    run("dual, non-queued", base, golden, queued_orientation=False)
    tuned = run("auto-tune", dataclasses.replace(
        base, auto_tune=True, tune_batches=3), golden)
    if not tuned._cfg_run.events_per_read < base.events_per_read:
        raise AssertionError("golden: auto-tune did not fire")
    log("golden", f"auto-tune fired: E {base.events_per_read} -> "
                  f"{tuned._cfg_run.events_per_read}")

    # long reads (101 to 992 bases) at the shapes the CLI picks from a
    # FASTQ peek
    long_fq = os.path.join(FIX, "reads_long.fq")
    L, K = autosize_shapes(long_fq)
    run(f"long reads, auto-sized (L, K) = {(L, K)}", dataclasses.replace(
        base, max_read_len=L, max_kmers_per_read=K),
        read("golden_long_output.vcf"), reads=long_fq)

    # stop after 8 batches with a checkpoint every 4; a second runner resumes
    ck = os.path.join(d, "ckpt")
    for ext in (".npz", ".json"):
        if os.path.exists(ck + ext):
            os.remove(ck + ext)
    first = GenoRunner(index, base, device=DEVICE, dix=dix)
    first.consume_fastq(fq, limit_batches=8, checkpoint_path=ck,
                        checkpoint_every=4)
    if not 0 < first.n_reads < 20000:
        raise AssertionError(f"golden: the stopped run read "
                             f"{first.n_reads} reads")
    second = GenoRunner(index, base, device=DEVICE, dix=dix)
    before = vote_fn.launches
    t0 = time.perf_counter()
    second.consume_fastq(fq, checkpoint_path=ck)
    second.write_vcf(vcf_in, out)
    check(f"checkpoint at {first.n_reads} reads, resumed", second,
          vote_fn.launches - before, time.perf_counter() - t0, golden)

    # two-sample cohort: the second sample stops after 2 batches
    cohort = CohortRunner(index, ["full", "part"], base, device=DEVICE)
    before = vote_fn.launches
    t0 = time.perf_counter()
    cohort.consume_sample("full", fq)
    cohort.consume_sample("part", fq, limit_batches=2)
    outs = cohort.write_vcfs(vcf_in, os.path.join(d, "cohort_{sample}.vcf"))
    check("cohort sample 1 of 2", cohort._runner,
          vote_fn.launches - before, time.perf_counter() - t0, golden,
          vcf_path=outs[0])
    with open(outs[1]) as f:
        if f.read() == golden:
            raise AssertionError("golden: the 2-batch cohort sample equals "
                                 "the full one")

    # the filt index, saved under its own prefix (its derived tables must
    # not land in the unfiltered index's cache)
    fprefix = os.path.join(d, "mini_filt")
    if not store.exists(fprefix):
        filt.filt_prefix(prefix, fprefix)
    findex = store.load(fprefix)
    run("filt index", base, read("golden_filt_output.vcf"), index=findex,
        dix=build_device_index(findex, DEVICE, base.ht_target_load))


def phase_mesh():
    """Both mesh runners on the mini fixture: D = 1 (``make_mesh(1)``) and
    D = 2 (cuda:0 named twice: a check of the routing and the lockstep on
    one card, not a deployment), the routed one also from a route_factor
    of 0.05 (it must escalate), cohort on D = 2, and a single-device
    checkpoint resumed on the D = 2 sharded-dictionary runner. Each VCF
    must be byte-identical to golden, with no overflow left and the vote
    kernel launched (its count set to 0 just before each run and read just
    after)."""
    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import ShardedGenoRunner, make_mesh
    from vargeno_tpu_torch.engine.cohort import CohortRunner
    from vargeno_tpu_torch.engine.geno import GenoRunner
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn

    d = os.path.join(CACHE, "mini")
    index = store.load(os.path.join(d, "mini"))
    fq, vcf_in = os.path.join(FIX, "reads.fq"), os.path.join(FIX, "snps.vcf")
    with open(os.path.join(FIX, "golden_output.vcf")) as f:
        golden = f.read()
    base = GenoConfig(batch_reads=512, max_read_len=128,
                      max_kmers_per_read=4)
    out = os.path.join(d, "mesh.vcf")

    def mesh_of(D):
        return make_mesh(1) if D == 1 else make_mesh(devices=["cuda:0"] * D)

    def finish(tag, runner, t0, vcf_path=out):
        launches = vote_fn.launches
        with open(vcf_path) as f:
            if f.read() != golden:
                raise AssertionError(f"mesh/{tag}: VCF differs from golden")
        check_no_overflow(runner, f"mesh/{tag}")
        if launches <= 0:
            raise AssertionError(f"mesh/{tag}: the vote kernel was never "
                                 f"launched")
        log("mesh", f"{tag}: VCF byte-identical to golden; {runner.n_reads} "
                    f"reads in {time.perf_counter() - t0:.2f} s, vote "
                    f"launches {launches}, escalations "
                    f"{runner.n_escalations}, route_overflow "
                    f"{runner.stats_totals.get('route_overflow', 'n/a')}")
        return runner

    def run(tag, cls, D, cfg=base):
        runner = cls(index, mesh_of(D), cfg)
        vote_fn.launches = 0
        t0 = time.perf_counter()
        runner.consume_fastq(fq)
        runner.write_vcf(vcf_in, out)
        return finish(tag, runner, t0)

    for D in (1, 2):
        run(f"replicated index, D = {D}", ShardedGenoRunner, D)
        run(f"sharded dictionary, D = {D}", ShardedDictGenoRunner, D)
    tiny = run("sharded dictionary, D = 2, route_factor 0.05",
               ShardedDictGenoRunner, 2,
               dataclasses.replace(base, route_factor=0.05,
                                   auto_retry_max=8))
    if not (tiny.n_escalations > 0 and tiny._cfg_run.route_factor > 0.05):
        raise AssertionError("mesh: route_factor 0.05 did not escalate")

    cohort = CohortRunner(index, ["full"], base, mesh=mesh_of(2))
    vote_fn.launches = 0
    t0 = time.perf_counter()
    cohort.consume_sample("full", fq)
    outs = cohort.write_vcfs(vcf_in, os.path.join(d, "mesh_{sample}.vcf"))
    finish("cohort on D = 2", cohort._runner, t0, vcf_path=outs[0])

    ck = os.path.join(d, "mesh_ckpt")
    for ext in (".npz", ".json"):
        if os.path.exists(ck + ext):
            os.remove(ck + ext)
    first = GenoRunner(index, base, device=DEVICE)
    first.consume_fastq(fq, limit_batches=8, checkpoint_path=ck,
                        checkpoint_every=4)
    resumed = ShardedDictGenoRunner(index, mesh_of(2), base)
    vote_fn.launches = 0
    t0 = time.perf_counter()
    resumed.consume_fastq(fq, checkpoint_path=ck)
    resumed.write_vcf(vcf_in, out)
    finish(f"single-device checkpoint at {first.n_reads} reads, resumed "
           f"on the sharded dictionary at D = 2", resumed, t0)


def check_scaling_point(tag: str, p: dict, batches: int, batch_reads: int):
    """A scaling tool's point: no overflow left, the vote kernel launched
    (in every process of a multi-process point), and reads in the timed
    window, at most ``batches`` global batches of ``batch_reads`` a shard.
    Not a whole number of them: the FASTQ reader ends a batch short at the
    end of each 256 MiB window of the file. A single-process point's
    window ran at least ``batches`` host-loop batches (its limit counts
    the retry batches too, as the JAX runner's loop does)."""
    launches = p["vote_launches"]
    launches = launches if isinstance(launches, list) else [launches]
    ok = 0 < p["reads"] <= batches * batch_reads * p["devices"] and \
        p.get("window_batches", batches) >= batches
    if p["overflow"] or min(launches) <= 0 or not ok:
        raise AssertionError(f"{tag}: overflow {p['overflow']}, vote "
                             f"launches {launches}, {p['reads']} reads: "
                             f"{p}")


def scaling_line(p: dict) -> str:
    eff = p.get("efficiency")
    return (f"{p['mode']} at D = {p['devices']}"
            + (f" ({p['procs']} processes over {p['backend']}, cards "
               f"{p['cards']})" if "procs" in p else "")
            + f": {p['reads']} reads"
            + (f" ({p['window_batches']} host-loop batches)"
               if "window_batches" in p else "")
            + f" in {p['seconds']:.4f} s = "
            f"{p['reads_per_sec']} reads/s"
            + (f", efficiency {eff}" if eff is not None else "")
            + f"; vote launches {p['vote_launches']}, peak device memory "
            f"{p['peak_bytes']} B")


def phase_scaling(card: str) -> dict:
    """The scaling tools on one card (checks of their paths, not scaling
    numbers): (a) ``python -m vargeno_tpu_torch.tools.bench_scaling
    --devices 1``; (b) its ``run_point`` at D = 2 naming cuda:0 twice,
    both modes, on the tool's synthetic draw; (c) ``python -m
    vargeno_tpu_torch.tools.bench_scaling_mh --procs 2 --devices-per-proc
    1`` naming cuda:0 for both processes over gloo (NCCL refuses a card
    shared by two processes). Every point: no overflow left, the vote
    kernel launched (in each process), the window's reads the tool's
    batches. Run beside phases that time nothing."""
    from vargeno_tpu_torch.testing import make_synthetic
    from vargeno_tpu_torch.tools import bench_scaling as bs

    t_phase = time.perf_counter()
    batches, batch = 8, 2048   # the tools' defaults
    out = {}
    got = last_json(run_tool("scaling", "bench_scaling", ["--devices", "1"],
                             dict(os.environ), 600))
    if [(p["mode"], p["devices"]) for p in got["results"]] != [("dp", 1)]:
        raise AssertionError(f"scaling: --devices 1 gave {got}")
    for p in got["results"]:
        check_scaling_point("scaling/tool", p, batches, batch)
        log("scaling", f"[{card}] bench_scaling --devices 1: "
                       + scaling_line(p))
    out["tool"] = got["results"]

    d = os.path.join(CACHE, "scaling")
    os.makedirs(d, exist_ok=True)
    index, _, _, fq = make_synthetic(
        seed=123, tmpdir=d, sizes=(2_000_000,), n_snps=5_000,
        n_reads=batch * 2 * (batches + 1))
    out["cuda0_twice"] = []
    for mode in bs.MODES:
        p, runner = bs.run_point(index, fq, mode, [f"{DEVICE}:0"] * 2,
                                 bs.point_config(batch), batches)
        del runner
        bs.release()
        check_scaling_point(f"scaling/D2/{mode}", p, batches, batch)
        log("scaling", f"[{card}] run_point naming cuda:0 twice (a check "
                       f"of the path): " + scaling_line(p))
        out["cuda0_twice"].append(p)
    del index

    got = last_json(run_tool(
        "scaling", "bench_scaling_mh", ["--procs", "2", "--devices-per-proc",
                                        "1", "--dist-backend", "gloo",
                                        "--cards", "cuda:0,cuda:0"],
        dict(os.environ), 1200))
    if [p["mode"] for p in got["results"]] != list(bs.MODES):
        raise AssertionError(f"scaling: bench_scaling_mh gave {got}")
    for p in got["results"]:
        check_scaling_point(f"scaling/mh/{p['mode']}", p, 6, batch)
        log("scaling", f"[{card}] bench_scaling_mh, 2 processes naming "
                       f"cuda:0 over gloo (a check of the protocol): "
                       + scaling_line(p))
    out["mh_gloo_2x1"] = got["results"]
    out["seconds"] = time.perf_counter() - t_phase
    log("scaling", f"phase scaling {out['seconds']:.1f} s")
    return out


def real_workload():
    """The real phase's workload: the bench tool's, cached here."""
    from vargeno_tpu_torch.tools.bench import Workload

    d, prefix = real_paths()
    wl = Workload(cache=d, mb=GENOME_MB, snps=N_SNPS, reads=N_READS,
                  batch=BATCH)
    if wl.prefix != prefix:
        raise RuntimeError(f"the bench tool's index prefix {wl.prefix} is "
                           f"not {prefix}")
    return wl


def prepare_real() -> int:
    """The real phase's dataset and index, made by the bench tool's own
    functions (so its ``ibuild.json`` records the build) in a process of its
    own (``start_real_prep``) beside the phases that time no reads/s;
    prints one JSON line ``{"real_prep": ...}``: the seconds of each, null
    where the cache already held it."""
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.tools import bench

    wl = real_workload()
    dataset_s = build_s = None
    if not os.path.exists(wl.path("ready")):
        t0 = time.perf_counter()
        bench.build_dataset(wl)
        dataset_s = time.perf_counter() - t0
        log("real", f"dataset written in {dataset_s:.2f} s")
    if not store.exists(wl.prefix):
        t0 = time.perf_counter()
        bench.build_index(wl)
        build_s = time.perf_counter() - t0
        log("real", f"index build {build_s:.2f} s")
    print(json.dumps({"real_prep": dict(dataset_s=dataset_s,
                                        build_s=build_s)}), flush=True)
    return 0


def start_session(cmd):
    """``cmd`` from the checkout's root in a session of its own (so that
    ``finish_tool`` can stop all it starts), its output piped."""
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def start_real_prep():
    return start_session([sys.executable, "-c", "import sys, chip_smoke; "
                          "sys.exit(chip_smoke.prepare_real())"])


def real_paths():
    """The real phase's cache directory and index prefix, in the bench
    tool's layout. Worked out without importing the package:
    ``--step-ops-of`` imports it from another checkout."""
    d = os.path.join(CACHE, f"bench{GENOME_MB}mb_{N_SNPS}snp_{N_READS}r")
    return d, os.path.join(d, "bench")


def inside_checkout(path: str) -> str:
    """``path`` made absolute; it must lie inside this checkout."""
    real = os.path.realpath(path)
    if os.path.commonpath([real, os.path.realpath(ROOT)]) \
            != os.path.realpath(ROOT):
        raise SystemExit(f"error: {path} is not inside {ROOT}")
    return real


def step_ops_of(pkg_root: str, routed: bool = False) -> int:
    """``--step-ops-of DIR``: profile one forward step (single orientation,
    default capacities, the workload's first batch, after one warm-up step)
    of the package in the checkout DIR, on this checkout's cached workload
    and index, and print one JSON line: the step's device operations, the
    microseconds of the one named ``vote_kernel`` and of all of them (null
    where the profiler did not keep the records); and, at the timed shapes'
    random streams, the (E, B) entry's time between CUDA events round one
    call and the vote kernel's own time inside it. Run in a process of its
    own: a profiler trace taken late in a long process loses device
    records. ``--routed-step-ops-of DIR``: the same forward step through the
    sharded-dictionary runner at D = 1 (routed backend, sorted search), the
    step's operations and times only."""
    sys.path.insert(0, inside_checkout(pkg_root))
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.engine.device_index import build_device_index
    from vargeno_tpu_torch.engine.geno import GenoRunner, _encoder
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes, iter_read_batches
    from vargeno_tpu_torch.kernels import vote
    from vargeno_tpu_torch.utils.profiling import device_ms

    d, prefix = real_paths()
    fq = os.path.join(d, "reads.fq")
    L, K = autosize_shapes(fq)
    index = store.load(prefix)
    cfg = GenoConfig(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
                     ht_target_load=HT_LOAD)
    b = next(iter(iter_read_batches(fq, BATCH, L, K)))
    enc = _encoder(K)(b.codes, b.n_kmers)
    if routed:
        from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
        from vargeno_tpu_torch.dist.sharding import make_mesh

        r = ShardedDictGenoRunner(index, make_mesh(1), cfg)
        args = r._upload(enc, b.qual)[0]
        proc = r._proc(cfg)[0]
        counts = (r.ref_cnt[0], r.alt_cnt[0])
    else:
        r = GenoRunner(index, cfg, device=DEVICE,
                       dix=build_device_index(index, DEVICE, HT_LOAD))
        args = r._upload(enc, b.qual)
        proc = r._proc(cfg)
        counts = (r.ref_cnt, r.alt_cnt)

    def step():
        return proc.single_enc(*args, *counts)
    step()
    torch.cuda.synchronize()
    n, records = device_ops(step)
    vote_us = [us for name, us in records if "vote_kernel" in name]
    out = {"step_ops": n, "vote_kernel_us": vote_us[-1] if vote_us else None,
           # both calls of the trace on record: the second one's time
           "busy_us": (sum(us for _, us in records[n:])
                       if len(records) == 2 * n else None),
           "eb_vote_kernel_us": {}, "eb_entry_ms": {}}
    # the (E, B) entry, which every checkout has, on the random streams
    for E, B, C in ([] if routed else VOTE_TIMED):
        quartet, ev_n, _ = random_events(E, B, C, seed=E * 1000 + C)

        def entry():
            return vote.vote_scan(*quartet, C, ev_n)
        out["eb_entry_ms"][str((E, B, C))] = device_ms(entry, DEVICE,
                                                       reps=20)
        out["eb_vote_kernel_us"][str((E, B, C))] = kernel_us(entry,
                                                             "vote_kernel")
    print(json.dumps(out), flush=True)
    return 0


def profiled_step(pkg_root: str, routed: bool = False) -> dict:
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--routed-step-ops-of" if routed else "--step-ops-of",
                        pkg_root],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"profiling the step of {pkg_root} failed:\n"
                           + r.stderr[-2000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


def phase_real(card: str, gather_rates: dict, parent: str | None,
               prep: dict):
    import numpy as np
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.engine.device_index import build_device_index
    from vargeno_tpu_torch.engine.geno import GenoRunner, _encoder
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes, iter_read_batches
    from vargeno_tpu_torch.kernels.vote import (NB_FLAG, VALID_FLAG,
                                                vote_scan,
                                                vote_scan_records,
                                                vote_scan_records_plain)
    from vargeno_tpu_torch.utils.roofline import roofline

    # the dataset and index come from prepare_real (``prep``: seconds)
    d, prefix = real_paths()
    vcf, fq = os.path.join(d, "snps.vcf"), os.path.join(d, "reads.fq")
    build_s = prep["build_s"]

    L, K = autosize_shapes(fq)
    cfg = GenoConfig(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
                     ht_target_load=HT_LOAD)
    on_cuda = DEVICE == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = store.load(prefix)
    dix = build_device_index(index, DEVICE, HT_LOAD)
    if on_cuda:
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log("real", f"index load + device tables {load_s:.2f} s, "
                f"{dix.nbytes()} bytes on {DEVICE} (both_ht "
                f"{dix.both_ht.numel() * 4} B, chain {dix.both_ht_chain})")

    # the main path: launch counts are reset just before and read just after
    runner = GenoRunner(index, cfg, device=DEVICE, dix=dix)
    vote_scan_records.launches = vote_scan.launches = 0
    t0 = time.perf_counter()
    runner.consume_fastq(fq)
    if on_cuda:
        torch.cuda.synchronize()
    geno_s = time.perf_counter() - t0
    launches = vote_scan_records.launches
    if vote_scan.launches:
        raise AssertionError("real: the step went through the (E, B) entry")
    rate = runner.n_reads / geno_s
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    st = runner.stats_totals
    check_no_overflow(runner, "real")
    rc, ac = runner.host_counts()
    if rc.shape != (dix.n_sites + 1,) or int(rc.sum() + ac.sum()) <= 0:
        raise AssertionError("real: empty or misshapen pileup counts")
    if st["n_processed"] < 0.5 * runner.n_reads:
        raise AssertionError(f"real: only {st['n_processed']} of "
                             f"{runner.n_reads} reads processed")
    out = os.path.join(d, "out.vcf")
    runner.write_vcf(vcf, out)
    with open(out) as f:
        n_calls = sum(1 for line in f if not line.startswith("#"))
    if n_calls <= 0:
        raise AssertionError("real: no genotype calls written")
    if on_cuda and launches <= 0:
        raise AssertionError("real: the vote kernel was never launched")
    log("real", f"[{card}] geno {runner.n_reads} reads in {geno_s:.3f} s = "
                f"{rate:.1f} reads/s (index load excluded); peak device "
                f"memory {peak} B; n_processed {st['n_processed']}, retry "
                f"reads {runner.n_retry_reads}, escalations "
                f"{runner.n_escalations}, vote launches {launches}, calls "
                f"{n_calls}, final caps "
                f"E={runner._cfg_run.events_per_read} "
                f"C={runner._cfg_run.candidates_per_read}")

    # roofline of that pass: its reads/s and measured retry fraction, the
    # escalated config it ended on, and the bench phase's measured rates
    report = roofline(runner._cfg_run, dix, torch.cuda.get_device_name(0)
                      if on_cuda else "cpu", BATCH, rate,
                      retry_frac=runner.n_retry_reads / runner.n_reads,
                      gather_rates=gather_rates)
    log("real", f"[{card}] roofline {json.dumps(report)}")

    # a second pass in this process with auto-tune on: equal counts, and
    # both rates side by side (one pass each: no ranking is claimed)
    tuned = GenoRunner(index, dataclasses.replace(cfg, auto_tune=True),
                       device=DEVICE, dix=dix)
    t0 = time.perf_counter()
    tuned.consume_fastq(fq)
    if on_cuda:
        torch.cuda.synchronize()
    tuned_rate = tuned.n_reads / (time.perf_counter() - t0)
    check_no_overflow(tuned, "real/auto-tune")
    t_rc, t_ac = tuned.host_counts()
    if not (np.array_equal(t_rc, rc) and np.array_equal(t_ac, ac)):
        raise AssertionError("real: the auto-tuned pass counts differently")
    tc = tuned._cfg_run
    if tc == cfg:
        raise AssertionError("real: auto-tune did not fire")
    log("real", f"[{card}] auto-tune pass {tuned_rate:.1f} reads/s against "
                f"{rate:.1f} untuned (one pass each), equal counts; "
                f"escalations {tuned.n_escalations}; tuned caps "
                f"E={tc.events_per_read} C={tc.candidates_per_read} "
                f"neighbor_item_frac={tc.neighbor_item_frac:.5f} "
                f"probe_hit_cap={tc.probe_hit_cap} "
                f"probe_active_frac={tc.probe_active_frac:.5f} "
                f"scan_active_frac={tc.scan_active_frac:.5f} "
                f"agree_cap={tc.agree_cap}")

    # cross-check: the first two batches, kernel vote vs plain vote; the
    # first forward batch's own records are kept for the timing below
    encode = _encoder(K)
    batches = []
    for b in iter_read_batches(fq, BATCH, L, K):
        batches.append((encode(b.codes, b.n_kmers), b.qual))
        if len(batches) == 2:
            break
    kept = []

    def keeping_vote(ev_idx, ev_meta, ev_total, C):
        if not kept:
            kept.append(((ev_idx, ev_meta, ev_total), C))
        return vote_scan_records(ev_idx, ev_meta, ev_total, C)

    outs = []
    for hook in (keeping_vote, vote_scan_records_plain):
        r = GenoRunner(index, runner._cfg_run, device=DEVICE, dix=dix,
                       vote=hook)
        masks = [r.run_batch(enc, q) for enc, q in batches]
        outs.append((r.host_counts(), masks))
    (k_rc, k_ac), k_masks = outs[0]
    (p_rc, p_ac), p_masks = outs[1]
    same = (np.array_equal(k_rc, p_rc) and np.array_equal(k_ac, p_ac)
            and all(np.array_equal(a, b) for ma, mb in zip(k_masks, p_masks)
                    for a, b in zip(ma, mb)))
    if not same:
        raise AssertionError("real: kernel and plain vote disagree on the "
                             "first two batches")
    log("real", f"first two batches: kernel and plain vote give equal "
                f"counts ({int(k_rc.sum())} ref, {int(k_ac.sum())} alt)")

    # the bare launch on the first forward batch's records (real reads,
    # real event counts)
    records, C = kept[0]
    B, E = records[0].shape
    real_raw_ms = time_vote_on_step("real", card, records, C)["raw_ms"]

    # device operations of one vote call: through the records entry, and
    # through the (E, B) entry the way the step fed it before (unpacked
    # and transposed views)
    def eb_call():
        ev_idx, meta, total = records
        return vote_scan(ev_idx.t(), (meta & 0x1F).t(),
                         ((meta & NB_FLAG) != 0).t(),
                         ((meta & VALID_FLAG) != 0).t(), C,
                         ev_n=total.clamp(max=E))
    vote_ops = count_device_ops(lambda: vote_scan_records(*records, C))
    eb_ops = count_device_ops(eb_call)
    if vote_ops > 3:
        raise AssertionError(f"real: a vote call is {vote_ops} device "
                             f"operations, more than 3")
    log("real", f"device operations of one vote call (torch.profiler): "
                f"{vote_ops} through the records entry, {eb_ops} through "
                f"the (E, B) entry on unpacked, transposed views")

    # one forward step of this checkout, and of the --parent checkout,
    # each profiled in a process of its own
    mine = profiled_step(ROOT)
    theirs = profiled_step(parent) if parent else None

    def told(got):
        return (f"{got['step_ops']} device operations, "
                f"{got['busy_us']} us on the card in all, vote kernel "
                f"{got['vote_kernel_us']} us")
    log("real", f"[{card}] one forward step (torch.profiler): {told(mine)}; "
                f"the same step of the parent checkout: "
                f"{told(theirs) if theirs else 'not run (no --parent)'}")
    for key, what in (("eb_vote_kernel_us", "vote kernel's own time (us, "
                       "torch.profiler)"),
                      ("eb_entry_ms", "(E, B) vote entry (ms between CUDA "
                       "events round one call)")):
        log("real", f"[{card}] {what} on the kernel phase's random streams: "
                    f"{json.dumps(mine[key])}; the parent checkout's: "
                    + (json.dumps(theirs[key]) if theirs
                       else "not run (no --parent)"))
    return dict(counts=(rc, ac), dix_bytes=dix.nbytes(),
                build_s=build_s, load_s=load_s, rate=rate,
                tuned_rate=tuned_rate, peak=peak, launches=launches,
                roofline=report, real_raw_ms=real_raw_ms,
                real_kernel_us=mine["vote_kernel_us"],
                kernel_us=mine["eb_vote_kernel_us"], parent=theirs,
                vote_call_ops=vote_ops, step_ops=mine["step_ops"])


def gil_released_by_event_wait() -> dict:
    """Whether ``torch.cuda.Event.synchronize`` releases the GIL: a thread
    waits on an event recorded behind a sleep kernel of about 0.2 s, while
    this thread counts loop turns until it is done. A wait that held the
    GIL would leave this thread next to no turns."""
    import threading

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(350_000_000)   # clock cycles
    issue_s = time.perf_counter() - t0
    ev = torch.cuda.Event()
    ev.record()
    waited = threading.Event()

    def wait():
        ev.synchronize()
        waited.set()

    t = threading.Thread(target=wait)
    t0 = time.perf_counter()
    t.start()
    turns = 0
    while not waited.is_set():
        turns += 1
    wait_s = time.perf_counter() - t0
    t.join()
    return dict(turns=turns, wait_s=wait_s, issue_s=issue_s,
                released=turns > 1000 and wait_s > 0.01)


def phase_pipeline(card: str) -> dict:
    """Phase 15 (module docstring): the host dispatch pipeline at every
    point of PIPELINE_POINTS on the real phase's workload and index, a
    forced escalation with batches in flight, the pinned buffers' check,
    the GIL check, the sharded dictionary and two processes under the
    pipeline, and the sweep tool. Returns the numbers it printed."""
    import dataclasses as dc
    import statistics

    import numpy as np
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import make_mesh
    from vargeno_tpu_torch.engine.device_index import build_device_index
    from vargeno_tpu_torch.engine.geno import (Fetch, GenoRunner, step_vec,
                                               unpack_vec)
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn
    from vargeno_tpu_torch.tools.bench import timed_pass
    from vargeno_tpu_torch.utils.profiling import StageTimer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    d, prefix = real_paths()
    vcf, fq = os.path.join(d, "snps.vcf"), os.path.join(d, "reads.fq")
    L, K = autosize_shapes(fq)
    base = GenoConfig(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
                      ht_target_load=HT_LOAD)
    index = store.load(prefix)
    dix = build_device_index(index, DEVICE, HT_LOAD)
    torch.cuda.synchronize()
    ref_vcf = None

    def vcf_of(runner, tag):
        out = os.path.join(d, f"pipeline_{tag}.vcf")
        runner.write_vcf(vcf, out)
        with open(out) as f:
            return f.read()

    def same_vcf(runner, tag):
        if vcf_of(runner, tag.replace(" ", "_").replace(",", "")) != ref_vcf:
            raise AssertionError(f"pipeline/{tag}: VCF differs from the "
                                 f"(1, 1, T) point's")

    points = {}
    for depth, group, pre in PIPELINE_POINTS:
        tag = f"({depth}, {group}, {'T' if pre else 'F'})"
        cfg = dc.replace(base, pipeline_depth=depth, group_size=group,
                         pre_encode=pre)
        runner = GenoRunner(index, cfg, device=DEVICE, dix=dix)
        runner.consume_fastq(fq, limit_batches=2 * group)   # warm
        runner.timer = StageTimer(sync=False)
        n0 = (runner.n_retry_batches, runner.n_escalations,
              runner.n_rewinds)
        vote_fn.launches = 0
        rates, counts = [], None
        for _ in range(PIPELINE_PASSES):
            rates.append(timed_pass(runner, fq))
            got = runner.host_counts()
            if counts is not None and not all(
                    np.array_equal(a, b) for a, b in zip(got, counts)):
                raise AssertionError(f"pipeline/{tag}: two passes count "
                                     f"differently")
            counts = got
        launches = vote_fn.launches
        check_no_overflow(runner, f"pipeline/{tag}")
        if launches <= 0:
            raise AssertionError(f"pipeline/{tag}: the vote kernel was "
                                 f"never launched")
        if ref_vcf is None:
            ref_vcf = vcf_of(runner, "reference")
        else:
            same_vcf(runner, tag)
        n = PIPELINE_PASSES
        stages = {k: v / n for k, v in sorted(runner.timer.totals.items())}
        got = dict(reads_s=statistics.median(rates), passes=rates,
                   retry_batches=(runner.n_retry_batches - n0[0]) / n,
                   escalations=runner.n_escalations - n0[1],
                   rewinds=runner.n_rewinds - n0[2],
                   vote_launches=launches, stages_s_a_pass=stages)
        points[tag] = got
        log("pipeline", f"[{card}] depth {depth}, group {group}, pre_encode "
                        f"{pre}: {got['reads_s']:.1f} reads/s (median of "
                        f"{[round(r, 1) for r in rates]}); VCF "
                        + ("the reference" if len(points) == 1 else
                           "byte-identical to (1, 1, T)")
                        + f"; a pass: {got['retry_batches']:.1f} retry "
                        f"batches; escalations {got['escalations']}, rewinds "
                        f"{got['rewinds']}, vote launches {launches} over "
                        f"{n} passes; main thread s a pass: "
                        + ", ".join(f"{k} {v:.4f}" for k, v in
                                    stages.items()))
        del runner

    # a forced escalation with batches in flight
    cfg = dc.replace(base, pipeline_depth=3, events_per_read=8, agree_cap=1)
    runner = GenoRunner(index, cfg, device=DEVICE, dix=dix)
    vote_fn.launches = 0
    t0 = time.perf_counter()
    runner.consume_fastq(fq)
    torch.cuda.synchronize()
    esc_s = time.perf_counter() - t0
    check_no_overflow(runner, "pipeline/forced escalation")
    if runner.n_escalations <= 0 or runner.n_rewinds <= 0:
        raise AssertionError(f"pipeline/forced escalation: escalations "
                             f"{runner.n_escalations}, rewinds "
                             f"{runner.n_rewinds}")
    if vote_fn.launches <= 0:
        raise AssertionError("pipeline/forced escalation: no vote launch")
    same_vcf(runner, "forced escalation")
    escalation = dict(escalations=runner.n_escalations,
                      rewinds=runner.n_rewinds, seconds=esc_s,
                      vote_launches=vote_fn.launches,
                      final_events_per_read=runner._cfg_run.events_per_read,
                      final_agree_cap=runner._cfg_run.agree_cap)
    log("pipeline", f"[{card}] forced escalation at depth 3 (events_per_read "
                    f"8, agree_cap 1): VCF byte-identical to (1, 1, T); "
                    f"escalations {runner.n_escalations}, rewinds "
                    f"{runner.n_rewinds} later in-flight batches redone, "
                    f"ending at events_per_read "
                    f"{escalation['final_events_per_read']}, agree_cap "
                    f"{escalation['final_agree_cap']}; {esc_s:.3f} s, vote "
                    f"launches {vote_fn.launches}")
    del runner

    # the pinned buffers: every finalized row against a depth-1 rerun
    cfg = dc.replace(base, pipeline_depth=3, group_size=2)
    runner = GenoRunner(index, cfg, device=DEVICE, dix=dix)
    kept, last = [], {}
    settle, finalize = runner._settle, runner._finalize

    def settled(*a):
        last["out"] = settle(*a)
        return last["out"]

    def finalized(p):
        masks = finalize(p)
        kept.append((p["kind"], p["args"], p["cfg"], last["out"][0], masks))
        return masks
    runner._settle, runner._finalize = settled, finalized
    runner.consume_fastq(fq)
    torch.cuda.synchronize()
    z = runner._fresh_counts()
    for i, (kind, args, pcfg, row, masks) in enumerate(kept):
        _, _, keys, vec = step_vec(runner._proc(pcfg), args, kind, *z)
        row1, masks1 = unpack_vec(Fetch([vec]).result()[0], keys,
                                  runner._mask_shape(kind, args))
        if row1 != row or not all(np.array_equal(a, b)
                                  for a, b in zip(masks, masks1)):
            raise AssertionError(f"pipeline/pinned buffers: handle {i} "
                                 f"({kind}) settled a row or masks other "
                                 f"than its own batch's")
    same_vcf(runner, "pinned buffers")
    log("pipeline", f"pinned buffers at depth 3, groups of 2: all "
                    f"{len(kept)} finalized handles' stats rows and masks "
                    f"equal to depth-1 reruns of their own batches "
                    f"({sum(k[0] == 'group' for k in kept)} groups)")
    n_checked = len(kept)
    del runner, kept, last

    gil = gil_released_by_event_wait()
    log("pipeline", f"torch.cuda.Event.synchronize "
                    + ("releases" if gil["released"] else "HOLDS")
                    + f" the GIL: this thread turned {gil['turns']} times "
                    f"while another waited {gil['wait_s']:.3f} s on an event "
                    f"(the sleep kernel issued in {gil['issue_s']:.4f} s)")

    # the sharded dictionary, D = 2 on cuda:0 twice, depth 2, groups of 2
    del dix
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sd = ShardedDictGenoRunner(index, make_mesh(devices=PIPELINE_DEVICES),
                               dc.replace(base, pipeline_depth=2,
                                          group_size=2))
    place_s = time.perf_counter() - t0
    vote_fn.launches = 0
    t0 = time.perf_counter()
    sd.consume_fastq(fq)
    torch.cuda.synchronize()
    sd_s = time.perf_counter() - t0
    check_no_overflow(sd, "pipeline/sharded dictionary")
    if vote_fn.launches <= 0:
        raise AssertionError("pipeline/sharded dictionary: no vote launch")
    same_vcf(sd, "sharded dictionary")
    sharded = dict(reads_s=sd.n_reads / sd_s, place_s=place_s,
                   escalations=sd.n_escalations, rewinds=sd.n_rewinds,
                   vote_launches=vote_fn.launches)
    log("pipeline", f"[{card}] sharded dictionary D = 2 on cuda:0 twice, "
                    f"depth 2, groups of 2: VCF byte-identical to (1, 1, T); "
                    f"{sharded['reads_s']:.1f} reads/s (placement "
                    f"{place_s:.2f} s excluded), escalations "
                    f"{sd.n_escalations}, rewinds {sd.n_rewinds}, vote "
                    f"launches {vote_fn.launches}")
    del sd
    gc.collect()
    torch.cuda.empty_cache()

    # 2 processes on cuda:0 over gloo, depth 2 against depth 1
    head = os.path.join(d, f"head{PIPELINE_MH_READS}.fq")
    if not os.path.exists(head):
        with open(fq) as src, open(head + ".tmp", "w") as dst:
            for _ in range(4 * PIPELINE_MH_READS):
                dst.write(src.readline())
        os.replace(head + ".tmp", head)
    outs = {k: os.path.join(d, f"pipeline_mh_depth{k}.vcf") for k in (1, 2)}
    spec = dict(prefix=prefix, fq=head, vcf_in=vcf,
                config=dict(batch_reads=BATCH, max_read_len=L,
                            max_kmers_per_read=K, ht_target_load=HT_LOAD),
                timeout=300,
                runs=[dict(tag=f"depth {k}", dict=True, queued=True,
                           cfg=dict(pipeline_depth=k), out=outs[k])
                      for k in (1, 2)])
    t0 = time.perf_counter()
    runs = finish_cluster(start_cluster(
        "pipeline, 2 processes on cuda:0 over gloo", "gloo",
        [[dev] for dev in PIPELINE_DEVICES], spec), 600)
    mh_wall = time.perf_counter() - t0
    for k in (1, 2):
        got = runs.get(f"depth {k}", [])
        if len(got) != 2 or any(g["overflow"] or g["vote_launches"] <= 0
                                for g in got):
            raise AssertionError(f"pipeline/2 processes, depth {k}: {got}")
    with open(outs[1]) as f, open(outs[2]) as g:
        if f.read() != g.read():
            raise AssertionError("pipeline/2 processes: the depth-2 VCF "
                                 "differs from the depth-1 one")
    mh = {k: dict(reads_s=v[0]["reads"] / max(g["geno_s"] for g in v),
                  retry_batches=v[0]["retry_batches"],
                  escalations=v[0]["escalations"],
                  vote_launches=[g["vote_launches"] for g in v])
          for k, v in runs.items()}
    log("pipeline", f"[{card}] 2 processes x 1 shard on cuda:0 over gloo, "
                    f"sharded dictionary, the first {PIPELINE_MH_READS} "
                    f"reads: the depth-2 VCF byte-identical to the depth-1 "
                    f"one; " + "; ".join(
                        f"{k}: {v['reads_s']:.1f} reads/s, "
                        f"{v['retry_batches']} lockstep retry batches, vote "
                        f"launches {v['vote_launches']}"
                        for k, v in mh.items())
                    + f"; cluster wall {mh_wall:.1f} s")

    # the sweep tool (quick points, one pass each)
    wl = real_workload()
    env = dict(os.environ, VGT_BENCH_CACHE=wl.cache,
               VGT_BENCH_MB=str(wl.mb), VGT_BENCH_SNPS=str(wl.snps),
               VGT_BENCH_READS=str(wl.reads), VGT_BENCH_BATCH=str(wl.batch))
    out = run_tool("pipeline", "tune_host_pipeline",
                   ["quick", "--passes", "1"], env, 600)
    for line in out.strip().splitlines()[:-1]:
        log("pipeline", f"tune_host_pipeline: {line}")
    tool = last_json(out)
    log("pipeline", f"tune_host_pipeline quick: {json.dumps(tool)}")
    seconds = time.perf_counter() - t_phase
    log("pipeline", f"phase pipeline {seconds:.1f} s")
    return dict(card=card, points=points, forced_escalation=escalation,
                pinned_handles_checked=n_checked, gil=gil,
                sharded_dict=sharded, multihost=mh, tool=tool,
                seconds=seconds)


def run_tool(tag: str, module: str, args, env: dict, timeout: float) -> str:
    """``python -m vargeno_tpu_torch.tools.<module> args`` from the
    checkout's root in a process of its own; its stderr lines are logged
    under ``tag``. Returns its stdout; a non-zero exit fails the phase."""
    r = subprocess.run([sys.executable, "-m",
                        f"vargeno_tpu_torch.tools.{module}", *args],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=timeout)
    for line in r.stderr.splitlines():
        log(tag, f"{module}: {line}")
    if r.returncode != 0:
        raise RuntimeError(f"{tag}: {module} exited {r.returncode}:\n"
                           + r.stdout[-2000:])
    return r.stdout


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def phase_geno_bench(card: str, gather_rates: dict, real: dict) -> dict:
    """The port's measurement entry points on the real phase's dataset and
    index (nothing built again), each a user's command line in a process of
    its own, alone on the card: (a) ``tools.bench`` (the headline reads/s
    line; the bench phase's gather rates handed over through its cache);
    (b) ``tools.bench_cohort --donors 8``. The bench's and every donor's
    counts must equal phase real's at every site."""
    import numpy as np
    import torch

    wl = real_workload()
    torch.cuda.empty_cache()   # the real phase's blocks, for the tools
    t_phase = time.perf_counter()
    with open(wl.path("gather_rates.json"), "w") as f:
        json.dump(gather_rates, f)
    env = dict(os.environ, VGT_BENCH_CACHE=wl.cache,
               VGT_BENCH_MB=str(wl.mb), VGT_BENCH_SNPS=str(wl.snps),
               VGT_BENCH_READS=str(wl.reads), VGT_BENCH_BATCH=str(wl.batch),
               VGT_BENCH_PASSES=str(wl.passes))
    rc, ac = real["counts"]

    def same(tag, ref, alt):
        if not (np.array_equal(ref, rc) and np.array_equal(alt, ac)):
            raise AssertionError(f"geno_bench: the {tag}'s counts differ "
                                 f"from phase real's")

    t0 = time.perf_counter()
    line = last_json(run_tool("geno_bench", "bench", [], env, 600))
    bench_s = time.perf_counter() - t0
    log("geno_bench", f"[{card}] bench line ({bench_s:.1f} s): "
                      f"{json.dumps(line)}")
    if line["passes_total"] < 5:
        raise AssertionError(f"geno_bench: {line['passes_total']} passes")
    if line["vote_launches"] <= 0:
        raise AssertionError("geno_bench: the bench never launched the vote "
                             "kernel")
    for k in ("lane_roofline_frac", "bw_roofline_frac"):
        if not (line[k] is not None and 0 < line[k] <= 1.05):
            raise AssertionError(f"geno_bench: {k} = {line[k]}")
    got = np.load(wl.path("bench_counts.npz"))
    same("bench", got["ref"], got["alt"])

    t0 = time.perf_counter()
    cohort = last_json(run_tool("geno_bench", "bench_cohort",
                                ["--donors", str(GENO_BENCH_DONORS)], env,
                                600))
    cohort_s = time.perf_counter() - t0
    log("geno_bench", f"[{card}] cohort line ({cohort_s:.1f} s): "
                      f"{json.dumps(cohort)}")
    if cohort["total_reads"] != GENO_BENCH_DONORS * wl.reads \
            or cohort["vote_launches"] <= 0:
        raise AssertionError(f"geno_bench: cohort {cohort}")
    got = np.load(wl.path("cohort_counts.npz"))
    for i in range(GENO_BENCH_DONORS):
        same(f"cohort donor d{i}", got[f"ref_d{i}"], got[f"alt_d{i}"])

    out = dict(card=card, bench=line, cohort=cohort,
               tool_s=dict(bench=bench_s, cohort=cohort_s),
               seconds=time.perf_counter() - t_phase)
    log("geno_bench", f"[{card}] phase geno_bench {out['seconds']:.1f} s")
    return out


def phase_routed(card: str, ht: dict) -> dict:
    """The 48 Mb workload through the sharded-dictionary runner, untuned, at
    D = 1 and D = 2 (cuda:0 named twice: a check, not a deployment), after
    the hash-table passes have freed their index: counts equal to the
    hash-table runner's, no overflow left, the vote kernel launched (count
    set to 0 just before each pass, read just after); reads/s,
    escalations, route_overflow, peak device memory (reset before each
    pass) and the index's device bytes beside the hash-table runner's. Then
    the device operations of one routed forward step, and the oracle spot
    check: the first 2,048 reads through the sequential oracle and through
    the D = 1 runner, every one of the 500,000 sites' counts equal."""
    import numpy as np
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import make_mesh
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes
    from vargeno_tpu_torch.kernels.vote import vote_scan_records
    from vargeno_tpu_torch.oracle import OracleEngine

    gc.collect()   # the hash-table passes' index, before peaks are taken
    d, prefix = real_paths()
    fq = os.path.join(d, "reads.fq")
    L, K = autosize_shapes(fq)
    cfg = GenoConfig(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
                     ht_target_load=HT_LOAD)
    index = store.load(prefix)
    ht_rc, ht_ac = ht["counts"]
    out = {}
    for D in (1, 2):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mesh = make_mesh(1) if D == 1 else make_mesh(devices=["cuda:0"] * D)
        runner = ShardedDictGenoRunner(index, mesh, cfg)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        vote_scan_records.launches = 0
        t0 = time.perf_counter()
        runner.consume_fastq(fq)
        torch.cuda.synchronize()
        geno_s = time.perf_counter() - t0
        launches = vote_scan_records.launches
        peak = torch.cuda.max_memory_allocated()
        check_no_overflow(runner, f"routed/D={D}")
        rc, ac = runner.host_counts()
        if not (np.array_equal(rc, ht_rc) and np.array_equal(ac, ht_ac)):
            raise AssertionError(f"routed/D={D}: counts differ from the "
                                 f"hash-table runner's")
        if launches <= 0:
            raise AssertionError(f"routed/D={D}: the vote kernel was never "
                                 f"launched")
        shard = runner.shards[0]
        row_b = (shard.ref_key.element_size()
                 + 2 * shard.dix.ref_meta.element_size())
        nbytes = runner.device_bytes()
        st = runner.stats_totals
        out[f"D{D}"] = dict(
            reads_s=runner.n_reads / geno_s, geno_s=geno_s, setup_s=setup_s,
            escalations=runner.n_escalations,
            route_overflow=st["route_overflow"],
            final_route_factor=runner._cfg_run.route_factor,
            retry_reads=runner.n_retry_reads, vote_launches=launches,
            peak_bytes=peak, index_bytes=nbytes, ref_row_bytes=row_b)
        what = " (cuda:0 twice: a check, not a deployment)" if D > 1 else ""
        log("real", f"[{card}] sharded dictionary, D = {D}{what}"
                    f": {runner.n_reads} reads in {geno_s:.3f} s = "
                    f"{runner.n_reads / geno_s:.1f} reads/s (partition + "
                    f"upload {setup_s:.2f} s excluded); counts equal to the "
                    f"hash-table runner's; escalations {runner.n_escalations}"
                    f" (route_factor {cfg.route_factor} -> "
                    f"{runner._cfg_run.route_factor}), route_overflow left "
                    f"{st['route_overflow']}, "
                    f"retry reads {runner.n_retry_reads}, vote launches "
                    f"{launches}; peak device memory {peak} B; index "
                    f"{nbytes} B on the card against the hash-table "
                    f"runner's {ht['dix_bytes']} B; {row_b} B a ref row "
                    f"(int64 key + meta)")
        del runner, mesh, shard   # before the next pass's peak is taken
    torch.cuda.empty_cache()

    routed = profiled_step(ROOT, routed=True)
    log("real", f"[{card}] one routed forward step at D = 1 "
                f"(torch.profiler): {routed['step_ops']} device operations, "
                f"{routed['busy_us']} us on the card in all, vote kernel "
                f"{routed['vote_kernel_us']} us; the hash-table step: "
                f"{ht['step_ops']} operations")
    out["routed_step"] = routed

    # oracle spot check on the first 2,048 reads
    head = os.path.join(d, "head2048.fq")
    with open(fq) as f, open(head, "w") as g:
        for i, line in enumerate(f):
            if i >= 4 * 2048:
                break
            g.write(line)
    t0 = time.perf_counter()
    eng = OracleEngine(index)
    eng.run_fastq(head)
    oracle_s = time.perf_counter() - t0
    runner = ShardedDictGenoRunner(index, make_mesh(1),
                                   dataclasses.replace(cfg, batch_reads=2048))
    runner.consume_fastq(head)
    check_no_overflow(runner, "oracle spot check")
    rc, ac = runner.host_counts()
    s = index.sites
    n = s.pos.shape[0]
    want_r = np.array([eng.pileup[int(p)][4] for p in s.pos])
    want_a = np.array([eng.pileup[int(p)][5] for p in s.pos])
    bad = int((np.minimum(rc[:n], cfg.max_cov) != want_r).sum()
              + (np.minimum(ac[:n], cfg.max_cov) != want_a).sum())
    if bad or int(want_r.sum() + want_a.sum()) <= 0:
        raise AssertionError(f"oracle spot check: {bad} count mismatches "
                             f"over {n} sites (or no counts)")
    log("real", f"oracle spot check: {runner.n_reads} reads, 0 count "
                f"mismatches over {n} sites ({int(want_r.sum())} ref and "
                f"{int(want_a.sum())} alt counts; oracle {oracle_s:.2f} s)")
    out["oracle"] = dict(reads=runner.n_reads, sites=n, mismatches=bad,
                         oracle_s=oracle_s)
    del runner
    return out


def mh_worker(spec: dict) -> int:
    """``--mh-worker SPEC``: one process of a multi-process cluster. Joins
    the group (``spec``: port, world, rank, backend, devices), loads the
    index once, and for each run in ``spec["runs"]`` builds the
    multi-process runner, drives ``consume_fastq`` (the vote kernel's
    count set to 0 just before, read just after; the processes start it
    together after a barrier; a run's ``checkpoint`` path is saved every
    ``checkpoint_every`` global batches, 64 by default, and resumed from
    when it exists) and ``write_vcf``, and prints one JSON line
    ``{"mh_run": ...}`` with what this process saw: among it each stage's
    peak RSS (load, setup, geno, vcf: ``rehearse_wgs.stage_rss``), each
    of its cards' peak device memory and ``aux_all`` bytes and the
    ambiguous-exact numbers of ``amb_summary``. A run with a ``counts``
    path also has process 0 save the merged per-site counts there
    (``np.savez``: ref, alt)."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist import multihost
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn
    from vargeno_tpu_torch.tools.bench_scaling import (peak_bytes,
                                                       reset_peaks, sync)
    from vargeno_tpu_torch.tools.endurance_wgs import checkpoint_offset
    from vargeno_tpu_torch.tools.rehearse_wgs import (record_first_attempt,
                                                      stage_rss)

    cluster = multihost.initialize(f"tcp://localhost:{spec['port']}",
                                   spec["world"], spec["rank"],
                                   spec["backend"], timeout=spec["timeout"])
    mesh = multihost.ProcessMesh(cluster, spec["devices"])
    cards = list(dict.fromkeys(mesh.devices))
    stages: dict = {}
    t0 = time.perf_counter()
    with stage_rss(stages, "load"):
        index = store.load(spec["prefix"])
    load_s = time.perf_counter() - t0
    for run in spec["runs"]:
        cls = (multihost.MultiHostDictGenoRunner if run["dict"]
               else multihost.MultiHostGenoRunner)
        cfg = GenoConfig(**{**spec["config"], **run.get("cfg", {})})
        gc.collect()
        torch.cuda.empty_cache()
        reset_peaks(cards)
        ck = run.get("checkpoint")
        resumed_from = (checkpoint_offset(ck) if ck else None) or 0
        t0 = time.perf_counter()
        with stage_rss(stages, "setup"):
            runner = cls(index, mesh, cfg, queued_orientation=run["queued"])
            sync(cards)
        setup_s = time.perf_counter() - t0
        first = record_first_attempt(runner)
        pass_s = []
        for k in range(run.get("passes", 1)):
            multihost.barrier(cluster)
            vote_fn.launches = 0
            t0 = time.perf_counter()
            with stage_rss(stages, "geno"):
                runner.consume_fastq(
                    spec["fq"], checkpoint_path=ck,
                    limit_batches=run.get("limit"),
                    checkpoint_every=run.get("checkpoint_every", 64))
                sync(cards)
            pass_s.append(time.perf_counter() - t0)
            if k:
                continue   # a later pass is timed only (counts add up)
            got = dict(
                tag=run["tag"], rank=cluster.rank, world=cluster.size,
                backend=cluster.backend, shards=runner.D,
                reads=runner.n_reads, geno_s=pass_s[0], setup_s=setup_s,
                vote_launches=vote_fn.launches,
                escalations=runner.n_escalations,
                batches=runner.meter.batches,
                retry_batches=runner.n_retry_batches,
                retry_reads=runner.n_retry_reads,
                overflow={key: v for key, v in runner.stats_totals.items()
                          if "overflow" in key and v},
                **amb_summary(runner, first))
            if run.get("counts"):   # a collective: every process calls it
                rc, ac = runner.host_counts()
                if cluster.rank == 0:
                    np.savez(run["counts"], ref=rc, alt=ac)
            t0 = time.perf_counter()
            with stage_rss(stages, "vcf"):
                runner.write_vcf(spec["vcf_in"], run["out"])
            got["vcf_s"] = time.perf_counter() - t0
        peaks = peak_bytes(cards)
        got.update(pass_s=pass_s, index_bytes=runner.device_bytes(),
                   aux_bytes=aux_bytes(runner),
                   peak_bytes=peaks[0], card_peak_bytes=peaks,
                   cards=[str(c) for c in cards], load_s=load_s,
                   resumed_from=resumed_from, stage_peak_rss=dict(stages))
        print(json.dumps({"mh_run": got}), flush=True)
        del runner
    multihost.shutdown(cluster)
    return 0


def worker_command(flag: str, spec: dict) -> list:
    """This script in a fresh interpreter as one process of a cluster
    (``--mh-worker`` or ``--cli-rank``)."""
    return [sys.executable, os.path.abspath(__file__), flag, json.dumps(spec)]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_cluster(name: str, backend: str, devices, common):
    """Start one worker process (a fresh interpreter) a rank, rank r on
    the devices ``devices[r]``; returns (name, processes)."""
    port = free_port()
    procs = []
    for rank, devs in enumerate(devices):
        spec = dict(common, port=port, world=len(devices), rank=rank,
                    backend=backend, devices=devs)
        procs.append(subprocess.Popen(
            worker_command("--mh-worker", spec), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return name, procs


def finish_cluster(cluster, timeout: float) -> dict:
    """Wait for a cluster's processes (all killed once ``timeout`` has
    passed); any failed process fails the phase. Returns {tag: [the run's
    line of each rank]}."""
    name, procs = cluster
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"multihost/{name}: the cluster did not finish "
                           f"within {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"multihost/{name}: processes (rank, exit code) "
                           f"{bad} failed:\n" + "\n".join(
                               err[-3000:] for _, err in outs))
    runs: dict = {}
    for out, _ in outs:
        for line in out.splitlines():
            if line.startswith('{"mh_run"'):
                got = json.loads(line)["mh_run"]
                runs.setdefault(got["tag"], []).append(got)
    return runs


def phase_multihost(card: str, routed: dict) -> dict:
    """Multi-process geno (``dist/multihost.py``) in fresh interpreters,
    each cluster under its own time limit; a failed process fails the
    phase. (a) The mini fixture on 2 processes x 1 shard, both naming
    cuda:0, over gloo (NCCL takes one process a card): data-parallel
    queued, inline dual, sharded dictionary, forced escalation, and a
    run stopped after 3 batches with a checkpoint that a single-process
    runner of the port resumes. (b) The same runs on one process at world
    size 1 over nccl (the stopped run resumed on it). Each VCF is
    byte-identical to golden, with no overflow left and the vote kernel
    launched in every process. (c) The 48 Mb workload, untuned, through the
    multi-process sharded dictionary on 2 processes on cuda:0 over gloo:
    its VCF byte-identical to the single-process hash-table pass's, no
    overflow, the vote kernel launched in each process; reads/s, each
    process's peak device memory and index bytes on the card, escalations
    and retry against forward batches, beside the threaded D = 2 rate of
    the routed phase. Two processes on one card check the protocol and the
    memory of a shard; they are not a deployment."""
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.engine.geno import GenoRunner
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes

    gc.collect()
    torch.cuda.empty_cache()
    d = os.path.join(CACHE, "mini")
    prefix = os.path.join(d, "mini")
    fq, vcf_in = os.path.join(FIX, "reads.fq"), os.path.join(FIX, "snps.vcf")
    with open(os.path.join(FIX, "golden_output.vcf")) as f:
        golden = f.read()
    base = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
    tiny = dict(events_per_read=4, probe_hit_cap=2, agree_cap=1)

    def mini_runs(tag, ck, resume):
        for ext in (".npz", ".json"):
            if os.path.exists(ck + ext):
                os.remove(ck + ext)
        runs = [dict(tag="queued", dict=False, queued=True),
                dict(tag="inline dual", dict=False, queued=False),
                dict(tag="sharded dictionary", dict=True, queued=True),
                dict(tag="forced escalation", dict=False, queued=True,
                     cfg=tiny),
                dict(tag="stopped at 3 batches", dict=False, queued=True,
                     checkpoint=ck, limit=3)]
        if resume:
            runs.append(dict(tag="resumed", dict=False, queued=True,
                             checkpoint=ck))
        for r in runs:
            r["out"] = os.path.join(d, f"mh_{tag}_{r['tag'].replace(' ', '_')}"
                                       f".vcf")
        return dict(prefix=prefix, fq=fq, vcf_in=vcf_in, config=base,
                    timeout=300, runs=runs)

    def check(name, runs, spec, world):
        for run in spec["runs"]:
            got = runs.get(run["tag"], [])
            if len(got) != world:
                raise AssertionError(f"multihost/{name}/{run['tag']}: "
                                     f"{len(got)} of {world} processes "
                                     f"reported")
            with open(run["out"]) as f:
                same = f.read() == golden
            if same == (run.get("limit") is not None):
                raise AssertionError(f"multihost/{name}/{run['tag']}: VCF "
                                     + ("equals" if same else "differs from")
                                     + " golden")
            for g in got:
                if g["overflow"] or g["vote_launches"] <= 0:
                    raise AssertionError(f"multihost/{name}/{run['tag']}: "
                                         f"rank {g['rank']}: {g}")
            if run["tag"] == "forced escalation" and not all(
                    g["escalations"] > 0 for g in got):
                raise AssertionError(f"multihost/{name}: the tiny caps did "
                                     f"not escalate")
            log("multihost", f"{name}, {run['tag']}: "
                + ("VCF byte-identical to golden" if same else
                   f"stopped at {got[0]['reads']} reads")
                + f"; vote launches per process "
                f"{[g['vote_launches'] for g in got]}, escalations "
                f"{got[0]['escalations']}, batches {got[0]['batches']} "
                f"({got[0]['retry_batches']} lockstep retry)")

    t0 = time.perf_counter()
    spec_a = mini_runs("gloo2", os.path.join(d, "mh_ck_a"), resume=False)
    spec_b = mini_runs("nccl1", os.path.join(d, "mh_ck_b"), resume=True)
    a = start_cluster("2 processes on cuda:0 over gloo", "gloo",
                      [["cuda:0"]] * 2, spec_a)
    b = start_cluster("1 process over nccl", "nccl", [["cuda:0"]], spec_b)
    runs_a, runs_b = finish_cluster(a, 600), finish_cluster(b, 600)
    check(a[0], runs_a, spec_a, 2)
    check(b[0], runs_b, spec_b, 1)

    # the 2-process checkpoint, resumed by the single-process runner
    index = store.load(prefix)
    resumed = GenoRunner(index, GenoConfig(**base), device=DEVICE)
    resumed.consume_fastq(fq, checkpoint_path=os.path.join(d, "mh_ck_a"))
    out = os.path.join(d, "mh_resumed_single.vcf")
    resumed.write_vcf(vcf_in, out)
    with open(out) as f:
        if f.read() != golden:
            raise AssertionError("multihost: the single-process runner's "
                                 "resume of the 2-process checkpoint "
                                 "differs from golden")
    check_no_overflow(resumed, "multihost/resumed")
    del resumed, index
    log("multihost", f"the 2-process checkpoint resumed by a single-process "
                     f"runner: VCF byte-identical to golden; mini clusters "
                     f"{time.perf_counter() - t0:.1f} s")

    # (c) the 48 Mb workload, 2 processes on one card
    rd, rprefix = real_paths()
    rfq = os.path.join(rd, "reads.fq")
    L, K = autosize_shapes(rfq)
    out = os.path.join(rd, "mh_out.vcf")
    spec_c = dict(prefix=rprefix, fq=rfq, vcf_in=os.path.join(rd,
                                                              "snps.vcf"),
                  config=dict(batch_reads=BATCH, max_read_len=L,
                              max_kmers_per_read=K, ht_target_load=HT_LOAD),
                  timeout=300, runs=[dict(tag="48 Mb", dict=True,
                                          queued=True, out=out)])
    t0 = time.perf_counter()
    c = start_cluster("48 Mb, 2 processes on cuda:0 over gloo", "gloo",
                      [["cuda:0"]] * 2, spec_c)
    got = finish_cluster(c, 900).get("48 Mb", [])
    wall_s = time.perf_counter() - t0
    if len(got) != 2:
        raise AssertionError(f"multihost/48 Mb: {len(got)} of 2 processes "
                             f"reported")
    with open(out) as f, open(os.path.join(rd, "out.vcf")) as g:
        if f.read() != g.read():
            raise AssertionError("multihost/48 Mb: the 2-process VCF differs "
                                 "from the single-process hash-table "
                                 "pass's")
    for g in got:
        if g["overflow"] or g["vote_launches"] <= 0:
            raise AssertionError(f"multihost/48 Mb: rank {g['rank']}: {g}")
    geno_s = max(g["geno_s"] for g in got)
    reads = got[0]["reads"]
    fwd = got[0]["batches"] - got[0]["retry_batches"]
    d2 = routed["D2"]["reads_s"]
    log("multihost", f"[{card}] 48 Mb through the multi-process sharded "
                     f"dictionary, 2 processes x 1 shard on cuda:0 over gloo "
                     f"(a check of the protocol and a shard's memory, not a "
                     f"deployment): VCF byte-identical to the single-process "
                     f"hash-table pass's; {reads} reads in {geno_s:.3f} s = "
                     f"{reads / geno_s:.1f} reads/s (the slower process's "
                     f"consume_fastq; partition + upload excluded), against "
                     f"{d2:.1f} reads/s for the threaded D = 2 pass of the "
                     f"routed phase in this run; escalations "
                     f"{got[0]['escalations']}; {fwd} forward + "
                     f"{got[0]['retry_batches']} lockstep retry batches; per "
                     f"process: vote launches "
                     f"{[g['vote_launches'] for g in got]}, peak device "
                     f"memory {[g['peak_bytes'] for g in got]} B, index "
                     f"{[g['index_bytes'] for g in got]} B on the card, "
                     f"setup {[round(g['setup_s'], 2) for g in got]} s; "
                     f"cluster wall {wall_s:.1f} s")
    return dict(
        mini={"gloo_2x1": {t: [g["vote_launches"] for g in v]
                           for t, v in runs_a.items()},
              "nccl_1x1": {t: [g["vote_launches"] for g in v]
                           for t, v in runs_b.items()}},
        mb48=dict(reads_s=reads / geno_s, geno_s=geno_s,
                  threaded_d2_reads_s=d2, forward_batches=fwd,
                  retry_batches=got[0]["retry_batches"],
                  escalations=got[0]["escalations"],
                  vote_launches=[g["vote_launches"] for g in got],
                  peak_bytes=[g["peak_bytes"] for g in got],
                  index_bytes=[g["index_bytes"] for g in got],
                  setup_s=[g["setup_s"] for g in got]))


def start_fuzz_big(root: str):
    """Phase fuzz (e): ``python -m vargeno_tpu_torch.tools.fuzz_diff 1
    FUZZ_BIG_SEED`` at VGT_FUZZ_BIG=1 in a fresh interpreter, its fixture
    in a temporary directory under ``root``. The tool runs the seed's
    fork-parallel oracle before its process touches the card."""
    tmp = os.path.join(root, "big")
    os.makedirs(tmp)
    return subprocess.Popen(
        [sys.executable, "-m", "vargeno_tpu_torch.tools.fuzz_diff", "1",
         str(FUZZ_BIG_SEED), "--device", "cuda"], cwd=ROOT,
        env=dict(os.environ, VGT_FUZZ_BIG="1", TMPDIR=tmp),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_fuzz_big(proc, timeout: float) -> dict:
    """Wait for the big seed's tool run and read its seed line."""
    import re

    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"fuzz/big seed: the tool did not finish within "
                           f"{timeout} s") from None
    for line in out.splitlines():
        log("fuzz", f"big seed: {line}")
    m = re.search(rf"^seed {FUZZ_BIG_SEED}: (PASS|FAIL) \(([\d.]+)s "
                  r"engine\+oracle\) (.*) mismatches=(\d+) "
                  r"escalations=(\d+) vote_launches=(\d+) "
                  r"overflow_left=(.*)$", out, re.M)
    if proc.returncode or not m or m.group(1) != "PASS":
        raise AssertionError(f"fuzz/big seed {FUZZ_BIG_SEED}: the tool "
                             f"exited {proc.returncode}:\n{out[-3000:]}"
                             f"\n{err[-3000:]}")
    return dict(seed=FUZZ_BIG_SEED, case=m.group(3),
                mismatches=int(m.group(4)), escalations=int(m.group(5)),
                vote_launches=int(m.group(6)), overflow_left=m.group(7),
                engine_oracle_s=float(m.group(2)),
                waited_s=time.perf_counter() - t0)


def phase_fuzz(card: str, beside=None) -> dict:
    """Differential fuzzing (``vargeno_tpu_torch/tools/fuzz_diff.py``) of
    every runner against the sequential oracle, seeds fixed in advance.
    (a) Seeds 0-23 (``FUZZ_SEEDS``), each through GenoRunner on the card
    as its draw says (queued or inline dual, its batch size and caps);
    (b) the same fixtures through the replicated-index mesh at D = 2 and
    (c) through the sharded dictionary at D = 1 and D = 2 (D = 2 names
    cuda:0 twice), each with the seed's own config; (d) seeds 0 and 1 on 2
    processes x 1 shard naming cuda:0 over gloo, replicated and sharded
    dictionary, each process loading the seed's index from the port's
    ``store.save``; (e) seed 0 at VGT_FUZZ_BIG scale through the tool's
    command line in a process of its own, beside (a)-(d) and then beside
    ``beside()`` (phase scaling, whose numbers are checks of its paths:
    the big seed is the phase's longest run), whose result is returned
    under ``beside``. Every run's
    ``min(count, 63)`` must equal the oracle's at every site, with no
    overflow left after escalation and the vote kernel launched (its
    count set to 0 just before each run and read just after). All runs
    go through before a failure is raised, so that every mismatch shows."""
    import shutil

    import numpy as np
    import torch

    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import ShardedGenoRunner
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn
    from vargeno_tpu_torch.tools import fuzz_diff

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    root = os.path.join(CACHE, "fuzz")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    mesh_runner = fuzz_diff.mesh_runner
    runners = {"GenoRunner": fuzz_diff.geno_runner,
               "replicated mesh, D = 2": mesh_runner(ShardedGenoRunner, 2),
               "sharded dictionary, D = 1":
                   mesh_runner(ShardedDictGenoRunner, 1),
               "sharded dictionary, D = 2":
                   mesh_runner(ShardedDictGenoRunner, 2)}
    tally: dict = {}
    failures = []

    def count(name, seed, mismatches, escalations, launches, seconds,
              overflow):
        t = tally.setdefault(name, dict(seeds=0, mismatches=0,
                                        escalations=0, vote_launches=0,
                                        seconds=0.0))
        t["seeds"] += 1
        t["mismatches"] += mismatches
        t["escalations"] += escalations
        t["vote_launches"] += launches
        t["seconds"] += seconds
        if mismatches or overflow or launches <= 0:
            failures.append(f"{name}, seed {seed}: {mismatches} mismatches, "
                            f"overflow left {overflow}, vote launches "
                            f"{launches}")

    def start_mh(prep, d):
        prefix = os.path.join(d, "index")
        store.save(prefix, prep.index)
        runs = [dict(tag=tag, dict=is_dict, queued=prep.case["queued"],
                     out=os.path.join(d, f"mh_{i}.vcf"),
                     counts=os.path.join(d, f"mh_{i}.npz"))
                for i, (tag, is_dict) in enumerate(
                    (("replicated", False), ("sharded dictionary", True)))]
        spec = dict(prefix=prefix, fq=prep.fq, vcf_in=prep.vcf,
                    config=prep.case["config"], timeout=300, runs=runs)
        return spec, start_cluster(
            f"fuzz seed {prep.case['seed']}, 2 processes on cuda:0 over "
            f"gloo", "gloo", [["cuda:0"]] * 2, spec)

    def finish_mh(prep, spec, cluster):
        runs = finish_cluster(cluster, 600)
        for run in spec["runs"]:
            got = runs.get(run["tag"], [])
            name = f"2 processes x 1 shard, {run['tag']}"
            if len(got) != 2:
                raise AssertionError(f"fuzz/{name}: {len(got)} of 2 "
                                     f"processes reported")
            with np.load(run["counts"]) as z:
                bad = fuzz_diff.bad_sites(prep, z["ref"], z["alt"])
            launches = [g["vote_launches"] for g in got]
            log("fuzz", f"{name}: seed {prep.case['seed']}: "
                        f"{'PASS' if not bad else 'FAIL'} "
                        f"{fuzz_diff.describe(prep.case)} mismatches="
                        f"{len(bad)} escalations="
                        f"{got[0]['escalations']} vote launches per process "
                        f"{launches} overflow left "
                        f"{[g['overflow'] for g in got]}")
            for line in bad[:10]:
                log("fuzz", line)
            count(name, prep.case["seed"], len(bad), got[0]["escalations"],
                  min(launches), max(g["geno_s"] for g in got),
                  [g["overflow"] for g in got if g["overflow"]])

    big = start_fuzz_big(root)   # (e) runs beside (a)-(d)
    clusters = []
    try:
        for seed in FUZZ_SEEDS:
            d = os.path.join(root, f"seed{seed}")
            os.makedirs(d)
            prep = fuzz_diff.prepare(seed, d, big=False)
            if seed in FUZZ_MH_SEEDS:
                clusters.append((prep, *start_mh(prep, d)))
            for name, make in runners.items():
                vote_fn.launches = 0
                got = fuzz_diff.check(
                    prep, "cuda:0", make,
                    say=lambda m, name=name: log("fuzz", f"{name}: {m}"))
                count(name, seed, got["mismatches"], got["escalations"],
                      vote_fn.launches, got["engine_s"], got["overflow"])
        for prep, spec, cluster in clusters:
            finish_mh(prep, spec, cluster)
        beside_got = beside() if beside is not None else None
        big_got = finish_fuzz_big(big, 780)
    finally:   # on a failure, stop what still runs
        for p in [big] + [p for _, _, (_, procs) in clusters for p in procs]:
            if p.poll() is None:
                p.kill()
                p.wait()
    name = f"GenoRunner, big seed {FUZZ_BIG_SEED}"
    count(name, FUZZ_BIG_SEED, big_got["mismatches"],
          big_got["escalations"], big_got["vote_launches"],
          big_got["engine_oracle_s"],
          "" if big_got["overflow_left"] == "0" else
          big_got["overflow_left"])
    for name, t in tally.items():
        log("fuzz", f"[{card}] {name}: seeds {t['seeds']}, mismatches "
                    f"{t['mismatches']}, escalations {t['escalations']}, "
                    f"vote launches {t['vote_launches']}, "
                    f"{t['seconds']:.1f} s")
    phase_s = time.perf_counter() - t_phase
    log("fuzz", f"phase fuzz {phase_s:.1f} s (the big seed's tool run "
                f"{big_got['engine_oracle_s']:.1f} s engine + oracle, beside "
                f"the rest" + (" and phase scaling" if beside else "") + ")")
    if failures:
        raise AssertionError("fuzz: " + "; ".join(failures))
    return dict(card=card, seeds=list(FUZZ_SEEDS),
                multiprocess_seeds=list(FUZZ_MH_SEEDS), runners=tally,
                big=big_got, seconds=phase_s, beside=beside_got)


def genome_dir() -> str:
    return os.path.join(CACHE, f"wgs{WGS_MB}mb_{WGS_SNPS}snp_{WGS_READS}r")


def tool_command(tool: str, *args) -> list:
    return [sys.executable, "-m", f"vargeno_tpu_torch.tools.{tool}",
            *map(str, args)]


def start_genome_background(go: str):
    """Phase genome (a) and (e), started after the build in a session of
    their own and run beside the phases that time no reads/s: (a) the
    rehearsal tool's command line (``--phase index``: synthesis of the
    genome, the VCF, the 262,144 reads and the 2,097,152 endurance reads,
    then the index build; host-only), then, once the file ``go`` exists
    (the main process makes it when the timed kernel and bench phases are
    over), (e) the endurance tool's command line: three fresh interpreters
    over the 2,097,152 reads on the sharded dictionary at D = 1, leg B
    killed at a checkpoint past half the stream, leg C resumed."""
    import shlex

    d = genome_dir()
    os.makedirs(d, exist_ok=True)
    prep = tool_command("rehearse_wgs", "--phase", "index", "--mb", WGS_MB,
                        "--snps", WGS_SNPS, "--reads", WGS_READS,
                        "--extra-reads", WGS_EXTRA_READS, "--cache", d)
    endure = tool_command(
        "endurance_wgs", "--cache", d, "--mb", WGS_MB, "--snps", WGS_SNPS,
        "--base-reads", WGS_READS, "--reads", WGS_EXTRA_READS, "--device",
        DEVICE, "--batch", BATCH, "--checkpoint-every", WGS_CHECKPOINT_EVERY,
        "--kill-after-frac", 0.5)
    script = (f"{shlex.join(prep)} && while [ ! -e {shlex.quote(go)} ]; "
              f"do sleep 1; done && {shlex.join(endure)}")
    return start_session(["/bin/sh", "-c", script])


def finish_tool(proc, timeout: float, tag: str, keys) -> dict:
    """Wait for a tool run started in a session of its own
    (``start_session``), print each line of its output under ``tag`` as it
    comes, and return its JSON lines ``{key: ...}`` for ``keys`` (a key it
    printed no line for is missing). The whole session is killed once
    ``timeout`` seconds have passed, and when the tool ends; a timeout or a
    non-zero exit fails the phase."""
    import threading

    expired = threading.Event()

    def stop():
        try:   # the tool and whatever of its session still runs
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    def expire():
        expired.set()
        stop()

    timer = threading.Timer(timeout, expire)
    timer.start()
    got = {}
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            log(tag, line)
            for key in keys:
                if line.startswith("{\"%s\"" % key):
                    got[key] = json.loads(line)[key]
        proc.wait()
    finally:
        timer.cancel()
        stop()
        proc.wait()
    if expired.is_set():
        raise RuntimeError(f"{tag}: the tool did not finish within "
                           f"{timeout} s")
    if proc.returncode:
        raise RuntimeError(f"{tag}: the tool exited {proc.returncode}")
    return got


def endurance_summary(card: str, end: dict, tag: str = "genome") -> dict:
    """Phase genome (e)'s result (and phase wgs's): leg B killed at a
    checkpoint past half the stream and before its end, leg C's VCF
    byte-identical to leg A's (the tool checks both and says ``ok``), and
    the vote kernel launched in legs A and C (counted in each leg's
    process)."""
    legs = end.get("legs", {})
    geno = {k: legs.get(k, {}).get("geno") or {} for k in "ABC"}
    if not end.get("ok") or not legs["B"]["killed"] or not all(
            geno[k].get("vote_launches", 0) > 0 for k in "AC"):
        raise AssertionError(f"{tag}: endurance failed: {end}")
    for k in "AC":
        log(tag, f"[{card}] endurance leg {k}: peak RSS by stage "
                 f"{geno[k].get('stage_peak_rss')}")
    log(tag, f"[{card}] endurance: {end['reads']} reads; leg B "
                  f"killed at checkpoint offset {end['killed_at_offset']} "
                  f"(kill point {end['kill_at']}); leg C resumed in "
                  f"{legs['C']['seconds']:.1f} s (streamed "
                  f"{geno['C']['reads']} reads in {geno['C']['seconds']:.2f}"
                  f" s); the resumed VCF is byte-identical to leg A's "
                  f"({end['vcf_bytes']} B); legs A / B / C "
                  f"{legs['A']['seconds']:.1f} / {legs['B']['seconds']:.1f} "
                  f"/ {legs['C']['seconds']:.1f} s; vote launches A "
                  f"{geno['A']['vote_launches']}, C "
                  f"{geno['C']['vote_launches']}")
    return dict(
        reads=end["reads"], kill_at=end["kill_at"],
        killed_at_offset=end["killed_at_offset"],
        vcf_bytes=end["vcf_bytes"], seconds=end["seconds"],
        legs={k: dict(wall_s=legs[k]["seconds"], killed=legs[k]["killed"],
                      **{f: geno[k].get(f) for f in (
                          "reads", "seconds", "reads_s", "resumed_from",
                          "vote_launches", "setup_s", "load_s", "vcf_s",
                          "peak_device_bytes", "index_device_bytes",
                          "peak_rss_bytes", "stage_peak_rss")})
              for k in "ABC"})


def sharded_genome_checks(tag: str, card: str, index, fq: str, mesh, cfg,
                          stages: dict, want=None, vcf=None):
    """Phase genome (c)-(d), phase wgs (b)-(c) and phase wgs_cards (b):
    the sharded dictionary of ``index`` placed, streamed, on ``mesh`` (its
    peak RSS as ``stages["placement"]``), ``fq`` streamed with no overflow
    left and the vote kernel launched (count set to 0 just before the
    stream, read just after), counts at every site (equal to ``want``, the
    hash table's (ref, alt) counts, where given), the VCF written where
    ``vcf`` = (input VCF, output path) is given, then oracle spot parity
    through the same runner: WGS_SPOT sampled reads, 0 mismatches over
    every site. Returns (its numbers, among them each card's index bytes,
    ``aux_all`` bytes and peak device memory, the index's aux rows and
    the stream's first attempt's ambiguous-exact numbers
    (``amb_summary``), and the first vote launch's records and C)."""
    import numpy as np
    import torch

    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import device_bytes
    from vargeno_tpu_torch.kernels.vote import vote_scan_records
    from vargeno_tpu_torch.tools import rehearse_wgs
    from vargeno_tpu_torch.tools.bench_scaling import (peak_bytes,
                                                       reset_peaks, sync)

    n_sites = int(index.sites.pos.shape[0])
    cards = list(dict.fromkeys(mesh.devices))
    kept = []

    def keeping_vote(ev_idx, ev_meta, ev_total, C):
        if not kept:
            kept.append(((ev_idx, ev_meta, ev_total), C))
        return vote_scan_records(ev_idx, ev_meta, ev_total, C)

    gc.collect()
    torch.cuda.empty_cache()
    reset_peaks(cards)
    t0 = time.perf_counter()
    with rehearse_wgs.stage_rss(stages, "placement"):
        runner = ShardedDictGenoRunner(index, mesh, cfg, vote=keeping_vote)
        sync(cards)
    setup_s = time.perf_counter() - t0
    vote_scan_records.launches = 0
    with rehearse_wgs.stage_rss(stages, "geno"):
        got = rehearse_wgs.stream(runner, fq, progress_every=0)
    launches = vote_scan_records.launches
    check_no_overflow(runner, tag)
    if launches <= 0:
        raise AssertionError(f"{tag}: the vote kernel was never launched")
    rc, ac = runner.host_counts()
    if rc.shape != (n_sites + 1,) or int(rc.sum() + ac.sum()) <= 0:
        raise AssertionError(f"{tag}: empty or misshapen counts")
    if want is not None and not (np.array_equal(rc, want[0])
                                 and np.array_equal(ac, want[1])):
        bad = int(((rc != want[0]) | (ac != want[1])).sum())
        raise AssertionError(f"{tag}: the sharded dictionary's counts "
                             f"differ from the hash table's at {bad} sites")
    peaks = peak_bytes(cards)
    out = dict(
        shards=len(mesh.devices), setup_s=setup_s,
        placement_peak_rss=stages["placement"], reads=got["reads"],
        geno_s=got["seconds"], reads_s=got["reads_s"],
        peak_bytes=max(p or 0 for p in peaks), card_peak_bytes=peaks,
        cards=[str(c) for c in cards],
        card_index_bytes=[device_bytes(
            t for s, dev in zip(runner.shards, mesh.devices) if dev == c
            for t in s.tensors()) for c in cards],
        index_bytes=runner.device_bytes(),
        shard_ref_rows=runner.shards[0].dix.n_ref_rows,
        vote_launches=launches, escalations=runner.n_escalations,
        route_overflow=runner.stats_totals["route_overflow"],
        final_route_factor=runner._cfg_run.route_factor,
        retry_reads=runner.n_retry_reads,
        retry_batches=runner.n_retry_batches, stats=got["stats"],
        **aux_rows(index), card_aux_bytes=aux_bytes(runner),
        **amb_summary(runner, got["first_attempt"]))
    log(tag, f"[{card}] sharded dictionary, D = {out['shards']}: streamed "
             f"placement {setup_s:.2f} s at a peak RSS of "
             f"{stages['placement']} B, {out['index_bytes']} B of index on "
             f"the card ({out['shard_ref_rows']} ref rows a shard); "
             f"{got['reads']} reads in {got['seconds']:.3f} s = "
             f"{got['reads_s']:.1f} reads/s"
             + (f"; counts equal to the hash table's at all {n_sites} "
                f"sites" if want is not None else "")
             + f"; peak device memory {out['peak_bytes']} B (per card "
             f"{out['cards']}: {peaks} B, index "
             f"{out['card_index_bytes']} B); escalations "
             f"{runner.n_escalations} (route_factor {cfg.route_factor} -> "
             f"{runner._cfg_run.route_factor}), vote launches {launches}; "
             f"aux rows: ref {out['n_ref_aux']}, SNP {out['snp_aux_rows']},"
             f" aux_all {out['card_aux_bytes']} B; first attempt: "
             f"{out['amb_hits_a_read']:.4f} ambiguous exact hits a read, "
             f"amb_overflow {out['first_amb_overflow']}; final "
             f"amb_hits_per_read {out['amb_hits_per_read']}")
    if vcf is not None:
        t0 = time.perf_counter()
        with rehearse_wgs.stage_rss(stages, "vcf"):
            runner.write_vcf(*vcf)
        out["vcf_s"] = time.perf_counter() - t0
        log(tag, f"VCF {vcf[1]} written in {out['vcf_s']:.2f} s")

    vote_scan_records.launches = 0
    with rehearse_wgs.stage_rss(stages, "spot"):
        spot = rehearse_wgs.spot_parity(index, runner, fq, WGS_SPOT)
    spot["vote_launches"] = vote_scan_records.launches
    out["spot"] = spot
    if spot["mismatches"] or spot["overflow"] or spot["increments"] <= 0 \
            or spot["vote_launches"] <= 0 or spot["reads"] != WGS_SPOT \
            or spot["sites"] != n_sites:
        raise AssertionError(f"{tag}: oracle spot parity failed: {spot}")
    log(tag, f"oracle spot parity: {spot['reads']} reads, 0 mismatches "
             f"over {spot['sites']} sites ({spot['increments']} site-count "
             f"increments; engine {spot['engine_s']:.2f} s, oracle "
             f"{spot['oracle_s']:.2f} s), vote launches "
             f"{spot['vote_launches']}")
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return out, kept[0]


def phase_genome(card: str, bg: dict) -> dict:
    """Genome scale on one card, at the JAX package's mid-scale point: a
    300 Mb genome, 3,000,000 SNPs, 262,144 reads of 101 bp, batch_reads
    32768, default capacities with escalation. (a) and (e) ran beside the
    earlier phases (``start_genome_background``; ``bg``: their JSON lines).
    (b) The hash-table runner (GenoRunner): derive the tables on the host,
    carry them to the card, stream the reads; reads/s (index load and
    derivation excluded), peak device memory, the index's device bytes, no
    overflow left, the vote kernel launched (count set to 0 just before
    the pass, read just after), and the bare vote launch timed on the
    first forward batch's own records. (c) With that index freed, the
    sharded dictionary at D = 1: the same numbers, counts equal to (b)'s
    at every site. (d) Oracle spot parity: 2,048 sampled reads through the
    D = 1 runner and the port's sequential oracle, 0 mismatches over every
    site. (e) is checked here (``endurance_summary``)."""
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist.sharding import make_mesh
    from vargeno_tpu_torch.engine.device_index import from_numpy, host_fields
    from vargeno_tpu_torch.engine.geno import GenoRunner, _encoder
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes, iter_read_batches
    from vargeno_tpu_torch.kernels.vote import vote_scan_records
    from vargeno_tpu_torch.tools import rehearse_wgs

    t_phase = time.perf_counter()
    prep = bg.get("index", {})
    d = genome_dir()
    prefix = os.path.join(d, "wgs")
    fq = os.path.join(d, "reads.fq")
    L, K = autosize_shapes(fq)
    cfg = GenoConfig(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
                     ht_target_load=HT_LOAD)
    host = rehearse_wgs.host_info(d)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    index = store.load(prefix)
    load_s = time.perf_counter() - t0
    n_sites = int(index.sites.pos.shape[0])
    n_ref, n_snp = int(index.ref.kmers.shape[0]), int(index.snp.kmers.shape[0])
    log("genome", f"[{card}] {WGS_MB} Mb, {n_sites} sites, {n_ref} ref rows, "
                  f"{n_snp} snp rows; synthesis {prep.get('gen_s')} s, extra "
                  f"reads {prep.get('extra_reads_s')} s, index build "
                  f"{prep.get('build_s')} s, {prep.get('disk_bytes')} B on "
                  f"disk, the builder's peak RSS {prep.get('peak_rss_bytes')} "
                  f"B (by stage {prep.get('stage_peak_rss')}); index load "
                  f"(mmap) {load_s:.2f} s; host MemTotal "
                  f"{host['mem_total']} B, free disk {host['disk_free']} B")
    if n_sites != WGS_SNPS:
        raise AssertionError(f"genome: {n_sites} sites, not {WGS_SNPS}")
    out = dict(card=card, mb=WGS_MB, snps=WGS_SNPS, reads=WGS_READS,
               batch_reads=BATCH, ref_rows=n_ref, snp_rows=n_snp,
               prep=prep, load_s=load_s, **host)

    # (b) the hash-table runner. Its derived tables are not written to the
    # index's derived_torch/ cache (prefix dropped): nothing in the run
    # reads them back, and the 34 GB table would take half of the 75 GB an
    # H100 host this phase was sized on had free
    torch.cuda.reset_peak_memory_stats()
    rss0 = rehearse_wgs.peak_rss()
    stages = {}
    t0 = time.perf_counter()
    with rehearse_wgs.stage_rss(stages, "derive"):
        fields, statics = host_fields(
            dataclasses.replace(index, prefix=None), HT_LOAD)
    derive_s = time.perf_counter() - t0
    table_b = int(fields["both_ht"].nbytes)
    t0 = time.perf_counter()
    with rehearse_wgs.stage_rss(stages, "upload"):
        dix = from_numpy(fields, statics, DEVICE)
        torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del fields
    derive_rss = rehearse_wgs.peak_rss()
    runner = GenoRunner(index, cfg, device=DEVICE, dix=dix)
    vote_scan_records.launches = 0
    t0 = time.perf_counter()
    runner.consume_fastq(fq)
    torch.cuda.synchronize()
    geno_s = time.perf_counter() - t0
    launches = vote_scan_records.launches
    check_no_overflow(runner, "genome/hash table")
    if launches <= 0:
        raise AssertionError("genome/hash table: the vote kernel was never "
                             "launched")
    ht_rc, ht_ac = runner.host_counts()
    if ht_rc.shape != (n_sites + 1,) or int(ht_rc.sum() + ht_ac.sum()) <= 0:
        raise AssertionError("genome/hash table: empty or misshapen counts")
    out["hash_table"] = dict(
        derive_s=derive_s, upload_s=upload_s, table_bytes=table_b,
        chain=dix.both_ht_chain, buckets=dix.both_ht_nb,
        derived_cache_bytes=0,
        host_peak_rss_before=rss0, host_peak_rss=derive_rss,
        stage_peak_rss=stages,
        reads_s=runner.n_reads / geno_s, geno_s=geno_s,
        peak_bytes=torch.cuda.max_memory_allocated(),
        index_bytes=dix.nbytes(), vote_launches=launches,
        escalations=runner.n_escalations, retry_reads=runner.n_retry_reads,
        n_processed=runner.stats_totals["n_processed"])
    log("genome", f"[{card}] hash table: derive {derive_s:.2f} s on the host "
                  f"(table {table_b} B, {dix.both_ht_nb} buckets, chain "
                  f"{dix.both_ht_chain}; cold: 0 B written to the derived "
                  f"cache, so no warm derivation), upload {upload_s:.2f} s, "
                  f"host peak RSS {derive_rss} B (derivation "
                  f"{stages['derive']} B, upload {stages['upload']} B); "
                  f"{runner.n_reads} reads in "
                  f"{geno_s:.3f} s = {runner.n_reads / geno_s:.1f} reads/s "
                  f"(index load and derivation excluded); peak device "
                  f"memory {out['hash_table']['peak_bytes']} B, index "
                  f"{dix.nbytes()} B on the card; escalations "
                  f"{runner.n_escalations}, retry reads "
                  f"{runner.n_retry_reads}, vote launches {launches}, "
                  f"n_processed {runner.stats_totals['n_processed']}")

    # the bare vote launch on a 300 Mb step's own records
    kept = []

    def keeping_vote(ev_idx, ev_meta, ev_total, C):
        if not kept:
            kept.append(((ev_idx, ev_meta, ev_total), C))
        return vote_scan_records(ev_idx, ev_meta, ev_total, C)

    b = next(iter(iter_read_batches(fq, BATCH, L, K)))
    GenoRunner(index, runner._cfg_run, device=DEVICE, dix=dix,
               vote=keeping_vote).run_batch(_encoder(K)(b.codes, b.n_kmers),
                                            b.qual)
    out["vote_on_step"] = time_vote_on_step("genome", card, *kept[0])
    del runner, dix, kept, b
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the sharded dictionary at D = 1, (d) oracle spot parity
    stages = {}
    out["sharded_d1"], _ = sharded_genome_checks(
        "genome", card, index, fq, make_mesh(1), cfg, stages,
        want=(ht_rc, ht_ac))
    out["sharded_d1"]["stage_peak_rss"] = stages
    del index
    gc.collect()

    out["endurance"] = endurance_summary(card, bg["endurance"])
    out["seconds"] = time.perf_counter() - t_phase
    log("genome", f"phase genome {out['seconds']:.1f} s")
    return out


def repeats_paths():
    """Phase repeats' cache directory and index prefix."""
    d = os.path.join(CACHE, f"repeats{GENOME_MB}mb_{N_SNPS}snp_{N_READS}r_"
                            f"dup{REPEATS_DUP_SHARE}")
    return d, os.path.join(d, "repeats")


def prepare_repeats() -> int:
    """Phase repeats' dataset, index and oracle counts, in a process of its
    own (``start_repeats_prep``) beside the phases that time no reads/s:
    bench.py's widths (48 Mb, 500,000 SNPs, 262,144 reads of 101 bp, 15 %
    single-base errors) on a genome from ``testing.synth_repeat_genome``
    (``REPEATS_DUP_SHARE`` of its bases in families of 2-10 copies with 1 %
    substitutions, and one 16-copy family), the index at the reference's
    Bloom geometry, then the sequential oracle fork-parallel over the first
    ``REPEATS_MH_READS`` reads (``head.fq``, the 2-process run's input) and
    over the rest (``tail.fq``): the counts after each (saturating sums, so
    the second are the whole file's) go to ``oracle.npz``. Prints one JSON
    line ``{"repeats_prep": ...}``: the seconds of each step, null where
    the cache already held it."""
    import numpy as np

    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.oracle import OracleEngine
    from vargeno_tpu_torch.testing import synth_repeat_genome, write_inputs
    from vargeno_tpu_torch.tools.fuzz_diff import site_counts

    d, prefix = repeats_paths()
    os.makedirs(d, exist_ok=True)
    fa, vcf = os.path.join(d, "genome.fa"), os.path.join(d, "snps.vcf")
    fq = os.path.join(d, "reads.fq")
    got = dict(dataset_s=None, build_s=None, oracle_s=None)
    ready = os.path.join(d, "ready")
    if not os.path.exists(ready):
        t0 = time.perf_counter()
        rng = np.random.default_rng(REPEATS_SEED)
        genome = synth_repeat_genome(rng, int(GENOME_MB * 1_000_000),
                                     REPEATS_DUP_SHARE)
        write_inputs(d, rng, genome, n_snps=N_SNPS, n_reads=N_READS,
                     read_len=101, err_frac=0.15)
        with open(fq) as f:
            lines = f.readlines()
        cut = 4 * REPEATS_MH_READS
        for name, part in (("head.fq", lines[:cut]), ("tail.fq",
                                                      lines[cut:])):
            with open(os.path.join(d, name), "w") as f:
                f.writelines(part)
        open(ready, "w").close()
        got["dataset_s"] = time.perf_counter() - t0
        log("repeats", f"dataset written in {got['dataset_s']:.2f} s")
    got["build_s"] = build_or_load_index(fa, vcf, prefix, "repeats")
    orc = os.path.join(d, "oracle.npz")
    if not os.path.exists(orc):
        t0 = time.perf_counter()
        index = store.load(prefix)
        oracle = OracleEngine(index)
        oracle.run_fastq_parallel(os.path.join(d, "head.fq"))
        head = site_counts(oracle, index)
        oracle.run_fastq_parallel(os.path.join(d, "tail.fq"))
        full = site_counts(oracle, index)
        got["oracle_s"] = time.perf_counter() - t0
        np.savez(orc, head_ref=head[0], head_alt=head[1], ref=full[0],
                 alt=full[1], seconds=got["oracle_s"])
        log("repeats", f"oracle over {N_READS} reads (fork-parallel) "
                       f"{got['oracle_s']:.2f} s")
    print(json.dumps({"repeats_prep": got}), flush=True)
    return 0


def start_repeats_prep():
    return start_session([sys.executable, "-c", "import sys, chip_smoke; "
                          "sys.exit(chip_smoke.prepare_repeats())"])


def phase_repeats(card: str, prep: dict) -> dict:
    """Exactness on a repeat-rich genome (``prepare_repeats`` made the
    dataset, index and oracle counts beside the earlier phases; ``prep``:
    their seconds). bench.py's widths at batch_reads 32768 and the real
    phase's default capacities, where the ambiguous-exact capacity
    (``amb_hits_per_read`` 0.25: 8,192 hits and 32,768 aux events a batch)
    must spill. Runs, each with the vote kernel's count set to 0 just
    before and read just after: GenoRunner queued and inline dual (one
    device index), the same queued with ``auto_retry_max=0`` (it must end
    with ``amb_overflow`` in its totals and the runner's warning), the
    sharded dictionary at D = 1 and D = 2 (cuda:0 twice: a check of
    routing and lockstep), and 2 processes x 1 shard on cuda:0 over gloo
    (``--mh-worker``; replicated and sharded dictionary) on the first
    ``REPEATS_MH_READS`` reads. Every run but the one without retry is held
    by ``tools/fuzz_diff``'s rule (``bad_sites``) to the oracle, with no
    overflow left; the single-card runs' VCFs must be byte-identical; the
    queued run's first attempt must have spilled. Each run prints the
    ambiguous exact hits a read of its first batch, its first attempt's
    ``amb_overflow``, escalations, the final ``amb_hits_per_read``,
    overflow left, mismatches, reads/s (its escalation redos included)
    and vote launches. All runs go through before a failure is raised."""
    import warnings

    import numpy as np
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import make_mesh
    from vargeno_tpu_torch.engine.device_index import build_device_index
    from vargeno_tpu_torch.engine.geno import GenoRunner
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn
    from vargeno_tpu_torch.tools import fuzz_diff
    from vargeno_tpu_torch.tools.rehearse_wgs import record_first_attempt

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    d, prefix = repeats_paths()
    vcf = os.path.join(d, "snps.vcf")
    fq, head_fq = os.path.join(d, "reads.fq"), os.path.join(d, "head.fq")
    L, K = autosize_shapes(fq)
    cfg = GenoConfig(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
                     ht_target_load=HT_LOAD)
    index = store.load(prefix)
    with np.load(os.path.join(d, "oracle.npz")) as z:
        orc = {k: z[k] for k in z.files}
    case = dict(seed=REPEATS_SEED,
                synth=dict(sizes=(int(GENOME_MB * 1_000_000),), n_snps=N_SNPS,
                           n_reads=N_READS, err_frac=0.15),
                config=dict(batch_reads=BATCH,
                            events_per_read=cfg.events_per_read,
                            agree_cap=cfg.agree_cap), queued=True)
    full = fuzz_diff.Prepared(case, index, vcf, fq, orc["ref"], orc["alt"],
                              float(orc["seconds"]))
    head = fuzz_diff.Prepared(
        dict(case, synth=dict(case["synth"], n_reads=REPEATS_MH_READS)),
        index, vcf, head_fq, orc["head_ref"], orc["head_alt"],
        float(orc["seconds"]))
    runs: dict = {}
    failures = []
    vcfs = {}

    def drive(name, runner, judge=True):
        first = record_first_attempt(runner)
        vote_fn.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            runner.consume_fastq(fq)
            torch.cuda.synchronize()
        geno_s = time.perf_counter() - t0
        bad = fuzz_diff.bad_sites(full, *runner.host_counts())
        got = dict(reads=runner.n_reads, geno_s=geno_s,
                   reads_s_with_redos=runner.n_reads / geno_s,
                   escalations=runner.n_escalations,
                   vote_launches=vote_fn.launches, mismatches=len(bad),
                   overflow_left={k: v for k, v in runner.stats_totals.items()
                                  if "overflow" in k and v},
                   warned=[str(w.message) for w in warned
                           if "overflow" in str(w.message)],
                   **amb_summary(runner, first))
        runs[name] = got
        log("repeats", f"[{card}] {name}: {runner.n_reads} reads, ambiguous "
                       f"exact hits a read (first batch) "
                       f"{got['amb_hits_a_read']:.4f}, first attempt's "
                       f"amb_overflow {got['first_amb_overflow']}, "
                       f"escalations {got['escalations']}, final "
                       f"amb_hits_per_read {got['amb_hits_per_read']}, "
                       f"overflow left {got['overflow_left'] or 0}, "
                       f"mismatches {len(bad)}, "
                       f"{got['reads_s_with_redos']:.1f} reads/s (escalation "
                       f"redos included), vote launches "
                       f"{got['vote_launches']}")
        for line in bad[:10]:
            log("repeats", line)
        if got["vote_launches"] <= 0:
            failures.append(f"{name}: the vote kernel was never launched")
        if judge and (bad or got["overflow_left"]):
            failures.append(f"{name}: {len(bad)} mismatches, overflow left "
                            f"{got['overflow_left']}")
        return got

    def write(name, runner):
        out = os.path.join(d, f"out_{len(vcfs)}.vcf")
        runner.write_vcf(vcf, out)
        with open(out, "rb") as f:
            vcfs[name] = f.read()

    t0 = time.perf_counter()
    dix = build_device_index(index, DEVICE, HT_LOAD)
    torch.cuda.synchronize()
    dix_s = time.perf_counter() - t0
    for name, queued in (("GenoRunner, queued", True),
                         ("GenoRunner, inline dual", False)):
        runner = GenoRunner(index, cfg, device=DEVICE, dix=dix,
                            queued_orientation=queued)
        drive(name, runner)
        write(name, runner)
    if runs["GenoRunner, queued"]["first_amb_overflow"] <= 0:
        failures.append("GenoRunner, queued: the first attempt did not "
                        "spill the ambiguous-exact capacity")
    name = "GenoRunner, queued, auto_retry_max=0"
    got = drive(name, GenoRunner(
        index, dataclasses.replace(cfg, auto_retry_max=0), device=DEVICE,
        dix=dix), judge=False)
    if not (got["overflow_left"].get("amb_overflow", 0) > 0
            and any("amb_overflow" in w for w in got["warned"])):
        failures.append(f"{name}: the spill was not reported "
                        f"({got['overflow_left']}, {got['warned']})")
    del dix, runner
    gc.collect()
    torch.cuda.empty_cache()
    for D in (1, 2):
        name = f"sharded dictionary, D = {D}"
        t0 = time.perf_counter()
        runner = ShardedDictGenoRunner(
            index, make_mesh(devices=[DEVICE] * D), cfg)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        drive(name, runner)["setup_s"] = setup_s
        write(name, runner)
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    names = list(vcfs)
    for name in names[1:]:
        if vcfs[name] != vcfs[names[0]]:
            failures.append(f"{name}: its VCF differs from "
                            f"{names[0]}'s")

    # 2 processes x 1 shard on cuda:0 over gloo, on the head of the reads
    runs_mh = [dict(tag=tag, dict=is_dict, queued=True,
                    out=os.path.join(d, f"mh_{i}.vcf"),
                    counts=os.path.join(d, f"mh_{i}.npz"))
               for i, (tag, is_dict) in enumerate(
                   (("replicated", False), ("sharded dictionary", True)))]
    spec = dict(prefix=prefix, fq=head_fq, vcf_in=vcf,
                config=dict(batch_reads=BATCH, max_read_len=L,
                            max_kmers_per_read=K, ht_target_load=HT_LOAD),
                timeout=300, runs=runs_mh)
    got_mh = finish_cluster(start_cluster(
        "repeats, 2 processes on cuda:0 over gloo", "gloo",
        [["cuda:0"]] * 2, spec), 600)
    for run in runs_mh:
        got = got_mh.get(run["tag"], [])
        name = f"2 processes x 1 shard, {run['tag']}"
        if len(got) != 2:
            failures.append(f"{name}: {len(got)} of 2 processes reported")
            continue
        with np.load(run["counts"]) as z:
            bad = fuzz_diff.bad_sites(head, z["ref"], z["alt"])
        launches = [g["vote_launches"] for g in got]
        g0 = got[0]
        runs[name] = dict(
            reads=g0["reads"], geno_s=max(g["geno_s"] for g in got),
            reads_s_with_redos=g0["reads"] / max(g["geno_s"] for g in got),
            escalations=g0["escalations"], vote_launches=launches,
            mismatches=len(bad),
            overflow_left=[g["overflow"] for g in got],
            amb_hits_a_read=g0["amb_hits_a_read"],
            first_amb_overflow=g0["first_amb_overflow"],
            amb_hits_per_read=[g["amb_hits_per_read"] for g in got])
        log("repeats", f"[{card}] {name}: {g0['reads']} reads, ambiguous "
                       f"exact hits a read (first batch) "
                       f"{g0['amb_hits_a_read']:.4f}, first attempt's "
                       f"amb_overflow {g0['first_amb_overflow']}, "
                       f"escalations {g0['escalations']}, final "
                       f"amb_hits_per_read a process "
                       f"{runs[name]['amb_hits_per_read']}, overflow left "
                       f"{runs[name]['overflow_left']}, mismatches "
                       f"{len(bad)}, {runs[name]['reads_s_with_redos']:.1f} "
                       f"reads/s (escalation redos included), vote "
                       f"launches per process {launches}")
        for line in bad[:10]:
            log("repeats", line)
        if bad or any(g["overflow"] for g in got) or min(launches) <= 0:
            failures.append(f"{name}: {len(bad)} mismatches, overflow left "
                            f"{runs[name]['overflow_left']}, vote launches "
                            f"{launches}")
        if len(set(map(str, runs[name]["amb_hits_per_read"]))) != 1:
            failures.append(f"{name}: the processes ended on different "
                            f"capacities")
    phase_s = time.perf_counter() - t_phase
    log("repeats", f"phase repeats {phase_s:.1f} s (device index "
                   f"{dix_s:.1f} s); its preparation beside the earlier "
                   f"phases: {json.dumps(prep)}")
    if failures:
        raise AssertionError("repeats: " + "; ".join(failures))
    return dict(card=card, dup_share=REPEATS_DUP_SHARE, seed=REPEATS_SEED,
                reads=N_READS, mh_reads=REPEATS_MH_READS, batch=BATCH,
                runs=runs, prep=prep, seconds=phase_s)


def wgs_dir() -> str:
    """The headline scale's cache directory; a repeat-rich draw's names its
    dup share, so that a uniform cache is never taken for it."""
    dup = f"_dup{WGS3_DUP_SHARE}" if WGS3_DUP_SHARE else ""
    return os.path.join(CACHE,
                        f"wgs{WGS3_MB}mb_{WGS3_SNPS}snp_{WGS_READS}r{dup}")


def wgs_setup(tag: str, card: str, devices: str, filt: bool = False):
    """The headline scale's directory, index prefix and reads, and the
    host (processors, MemTotal, free disk) logged; before a build, the
    free disk for the index (``<dir>/wgs.vgt`` may link to another file
    system) and for the inputs and outputs is checked, and with ``filt``
    always that for the filtered index beside them."""
    import shutil

    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.tools import rehearse_wgs

    d = wgs_dir()
    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, "wgs")
    host = rehearse_wgs.host_info(d)
    log(tag, f"[{card}] {WGS3_MB} Mb, {WGS3_SNPS} SNPs, {WGS_READS} reads, "
             f"dup share {WGS3_DUP_SHARE}, batch_reads {BATCH}, devices "
             f"{devices}; host: "
             f"{host['nproc']} processors, MemTotal {host['mem_total']} B, "
             f"free disk {host['disk_free']} B")
    vgt = os.path.realpath(prefix + ".vgt")
    wants = [(d, WGS3_FILT_DISK)] if filt else []
    if not store.exists(prefix):
        wants += [(d, WGS3_IO_DISK),
                  (vgt if os.path.isdir(vgt) else d, WGS3_INDEX_DISK)]
    need = {}   # file system -> (a path on it, bytes needed)
    for path, n in wants:
        p0, n0 = need.get(os.stat(path).st_dev, (path, 0))
        need[os.stat(path).st_dev] = (p0, n0 + n)
    for path, n in need.values():
        free = shutil.disk_usage(path).free
        if free < n:
            raise RuntimeError(f"{tag}: {free} B free under {path}, the "
                               f"run needs {n:.0f}")
    log(tag, f"inputs and outputs in {d}, the index in {vgt}")
    return d, prefix, os.path.join(d, "reads.fq"), host


def start_wgs_index(filt: bool = False):
    """The headline scale's synthesis (the reads and the endurance reads
    too; repeat-rich at WGS3_DUP_SHARE) and index build: the rehearsal
    tool's command line in a session of its own (host only). With
    ``filt``, the tool then runs ``filt`` through the CLI in a process of
    its own (``--filt``), and no endurance reads are drawn."""
    more = (["--filt"] if filt
            else ["--extra-reads", WGS_EXTRA_READS])
    return start_session(tool_command(
        "rehearse_wgs", "--phase", "index", "--mb", WGS3_MB, "--snps",
        WGS3_SNPS, "--reads", WGS_READS, "--dup-share", WGS3_DUP_SHARE,
        *more, "--cache", wgs_dir(), "--progress-every", 0))


def check_sites(tag: str, n_sites: int) -> None:
    """The index holds this draw's sites: on the uniform draw one a SNP. A
    SNP seeds a site only through an unambiguous SNP-dictionary row
    (src/qv.cc:637-660), so on a repeat-rich draw a few SNPs in families
    seed none, as in the reference: there at least 99 % of the SNPs must
    seed one."""
    low = WGS3_SNPS if not WGS3_DUP_SHARE else 0.99 * WGS3_SNPS
    if not low <= n_sites <= WGS3_SNPS:
        raise AssertionError(f"{tag}: {n_sites} sites of {WGS3_SNPS} SNPs")
    log(tag, f"{n_sites} sites of {WGS3_SNPS} SNPs ({WGS3_SNPS - n_sites} "
             f"seed none: no unambiguous SNP-dictionary row)")


def check_spill(tag: str, sharded: dict) -> None:
    """On a repeat-rich draw, the one-process stream's first attempt must
    have spilled the ambiguous-exact capacity (so escalation was
    reached)."""
    if WGS3_DUP_SHARE and sharded["first_amb_overflow"] <= 0:
        raise AssertionError(f"{tag}: the first attempt did not spill the "
                             f"ambiguous-exact capacity "
                             f"({sharded['amb_hits_a_read']:.4f} hits a "
                             f"read)")


def phase_wgs(card: str) -> dict:
    """``--wgs``: the whole genome on one card (see the module's
    docstring): synthesis and the bucketed build in the rehearsal tool's
    own process; here the mmap'd index, the streamed D = 2 placement, the
    stream with no overflow left and the vote kernel launched, the bare
    vote launch on the first batch's records, oracle spot parity over
    every site; then the endurance tool's legs at D = 2. Each stage's
    peak RSS must stay under the host's MemTotal."""
    from vargeno_tpu_torch.dist.sharding import make_mesh
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.tools import rehearse_wgs

    t_phase = time.perf_counter()
    d, prefix, fq, host = wgs_setup("wgs", card, WGS3_DEVICES)

    # (a) synthesis and the index build
    t0 = time.perf_counter()
    prep = finish_tool(start_wgs_index(), 3000, "wgs",
                       ("index",)).get("index", {})
    prep_s = time.perf_counter() - t0
    stages = dict(prep.get("stage_peak_rss", {}))

    # (b) the index through mmap, the streamed D = 2 placement, the
    # stream, (c) oracle spot parity
    t0 = time.perf_counter()
    with rehearse_wgs.stage_rss(stages, "load"):
        index = store.load(prefix)
    load_s = time.perf_counter() - t0
    n_sites = int(index.sites.pos.shape[0])
    n_ref, n_snp = int(index.ref.kmers.shape[0]), int(index.snp.kmers.shape[0])
    log("wgs", f"[{card}] index loaded (mmap) in {load_s:.2f} s: {n_ref} ref "
               f"rows, {n_snp} snp rows, {n_sites} sites")
    check_sites("wgs", n_sites)
    sharded, first = sharded_genome_checks(
        "wgs", card, index, fq, make_mesh(devices=WGS3_DEVICES.split(",")),
        rehearse_wgs.geno_config(BATCH), stages)
    check_spill("wgs", sharded)
    del index
    gc.collect()
    vote_on_step = time_vote_on_step("wgs", card, *first)
    del first

    # (d) kill / resume at D = 2
    end = finish_tool(start_session(tool_command(
        "endurance_wgs", "--cache", d, "--mb", WGS3_MB, "--snps", WGS3_SNPS,
        "--base-reads", WGS_READS, "--dup-share", WGS3_DUP_SHARE,
        "--reads", WGS_EXTRA_READS, "--device", DEVICE, "--devices",
        WGS3_DEVICES, "--batch", BATCH,
        "--checkpoint-every", WGS_CHECKPOINT_EVERY, "--kill-after-frac",
        0.5)), 2400, "wgs", ("endurance",)).get("endurance", {})
    endurance = endurance_summary(card, end, "wgs")
    for k in "AC":
        for name, v in (endurance["legs"][k]["stage_peak_rss"] or {}).items():
            stages[f"leg {k} {name}"] = v
    over = {k: v for k, v in stages.items() if v >= host["mem_total"]}
    if over:
        raise AssertionError(f"wgs: stages at the host's MemTotal "
                             f"({host['mem_total']} B): {over}")
    out = dict(
        card=card, mb=WGS3_MB, snps=WGS3_SNPS, reads=WGS_READS,
        dup_share=WGS3_DUP_SHARE, batch_reads=BATCH, devices=WGS3_DEVICES,
        ref_rows=n_ref, snp_rows=n_snp, host=host, prep=prep, prep_s=prep_s,
        load_s=load_s, sharded=sharded, vote_on_step=vote_on_step,
        endurance=endurance, stage_peak_rss=stages,
        seconds=time.perf_counter() - t_phase)
    log("wgs", f"[{card}] peak RSS by stage (B): {json.dumps(stages)}; "
               f"phase wgs {out['seconds']:.1f} s")
    return out


def phase_wgs_filt(card: str) -> dict:
    """``--wgs --filt``: the paper's workflow (index, filt, geno) at the
    headline scale on one card (see the module's docstring): (a) synthesis
    and the bucketed build and (b) ``filt`` through the CLI, each in the
    rehearsal tool's process (``--filt``) and a process of the CLI's own;
    (c) the filtered index mmap'd, placed at D = 1 on WGS3_FILT_DEVICES
    and streamed (``sharded_genome_checks``: no overflow left, the vote
    kernel launched, the VCF, oracle spot parity over every site against
    the oracle on the filtered index), the bare vote launch on the first
    batch's records; (d) ``geno`` through the CLI on the filtered index
    and the same reads (``--cli-rank``), its VCF byte-identical to (c)'s.
    Each stage's peak RSS must stay under the host's MemTotal. The hash
    table of the filtered index is not run: it does not fit the card
    (PERF.md)."""
    import shutil

    from vargeno_tpu_torch.dist.sharding import make_mesh
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.tools import rehearse_wgs

    tag = "wgs_filt"
    t_phase = time.perf_counter()
    # (b) is measured in every run: a prior filtered index is cleared
    # first (behind the link, where <dir>/wgs_filt.vgt is one)
    fvgt = os.path.realpath(os.path.join(wgs_dir(), "wgs_filt.vgt"))
    for name in os.listdir(fvgt) if os.path.isdir(fvgt) else ():
        path = os.path.join(fvgt, name)
        if os.path.isdir(path) and not os.path.islink(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
    d, prefix, fq, host = wgs_setup(tag, card, WGS3_FILT_DEVICES, filt=True)
    fprefix = os.path.join(d, "wgs_filt")

    # (a) synthesis and the index build, (b) filt through the CLI
    t0 = time.perf_counter()
    prep = finish_tool(start_wgs_index(filt=True), 3000, tag,
                       ("index", "filt"))
    prep_s = time.perf_counter() - t0
    if "filt" not in prep:
        raise AssertionError(f"{tag}: the tool printed no filt line")
    fl = prep["filt"]
    stages = dict(fl["stage_peak_rss"])
    log(tag, f"[{card}] filt (the CLI, a process of its own): kept "
             f"{fl['kept_rows']} of {fl['ref_rows']} ref rows (share "
             f"{fl['kept_share']:.4f}) in {fl['filt_s']:.2f} s at a peak "
             f"RSS of {fl['peak_rss']} B ({fl['rss_before']} B as the "
             f"filt started, after its imports); the filtered index "
             f"{fl['disk_bytes']} B on disk; synthesis, build and filt "
             f"{prep_s:.1f} s")

    # (c) the filtered index at D = 1
    t0 = time.perf_counter()
    with rehearse_wgs.stage_rss(stages, "load"):
        index = store.load(fprefix)
    load_s = time.perf_counter() - t0
    n_sites = int(index.sites.pos.shape[0])
    n_ref = int(index.ref.kmers.shape[0])
    if n_ref != fl["kept_rows"]:
        raise AssertionError(f"{tag}: {n_ref} ref rows loaded, filt kept "
                             f"{fl['kept_rows']}")
    check_sites(tag, n_sites)
    vcf_in = os.path.join(d, "snps.vcf")
    vcf_c = os.path.join(d, "wgs_filt_c.vcf")
    sharded, first = sharded_genome_checks(
        tag, card, index, fq,
        make_mesh(devices=WGS3_FILT_DEVICES.split(",")),
        rehearse_wgs.geno_config(BATCH), stages, vcf=(vcf_in, vcf_c))
    forward = -(-WGS_READS // BATCH)
    log(tag, f"[{card}] batches: {forward} forward, "
             f"{sharded['retry_batches']} of retries "
             f"({sharded['retry_reads']} reads re-run reverse-complemented)")
    del index
    gc.collect()
    vote_on_step = time_vote_on_step(tag, card, *first)
    del first

    # (d) geno through the CLI on the filtered index, the same reads
    vcf_d = os.path.join(d, "wgs_filt_d.vcf")
    _, lines, _, wall_s = run_cluster_leg(
        f"{tag} (d)", [worker_command("--cli-rank", dict(
            tag=f"{tag} (d)", argv=[
                "geno", fprefix, fq, vcf_in, vcf_d, "--device", DEVICE,
                "--mesh", str(len(WGS3_FILT_DEVICES.split(","))),
                "--sharded-dict", "--batch-reads", str(BATCH)]))],
        "cli_rank", 1500)
    cli = lines[0][0]
    with open(vcf_c, "rb") as f, open(vcf_d, "rb") as g:
        same = f.read() == g.read()
    stages.update({f"(d) {k}": v for k, v in cli["stage_peak_rss"].items()})
    log(tag, f"[{card}] geno through the CLI on the filtered index: VCF "
             + ("byte-identical to (c)'s" if same else "DIFFERS from (c)'s")
             + f"; placement {cli['stage_s']['placement']:.2f} s, stream "
             f"{cli['stage_s']['geno']:.2f} s, VCF "
             f"{cli['stage_s']['vcf']:.2f} s, process {cli['seconds']:.1f} "
             f"s (wall {wall_s:.1f} s); vote launches "
             f"{cli['vote_launches']}, escalations {cli['escalations']}, "
             f"index {cli['index_bytes']} B, peak device memory "
             f"{cli['card_peak_bytes']} B, peak RSS {cli['stage_peak_rss']}")
    if not same or cli["rc"] or cli["overflow"] or cli["vote_launches"] <= 0:
        raise AssertionError(f"{tag} (d): VCF equal {same}, {cli}")
    over = {k: v for k, v in stages.items() if v >= host["mem_total"]}
    if over:
        raise AssertionError(f"{tag}: stages at the host's MemTotal "
                             f"({host['mem_total']} B): {over}")
    out = dict(
        card=card, mb=WGS3_MB, snps=WGS3_SNPS, reads=WGS_READS,
        dup_share=WGS3_DUP_SHARE, batch_reads=BATCH,
        devices=WGS3_FILT_DEVICES, host=host, index=prep.get("index"),
        filt=fl, prep_s=prep_s, load_s=load_s, ref_rows=n_ref,
        forward_batches=forward, sharded=sharded, vote_on_step=vote_on_step,
        cli=dict(wall_s=wall_s, vcf_equal=same, **cli),
        stage_peak_rss=stages, seconds=time.perf_counter() - t_phase)
    log(tag, f"[{card}] peak RSS by stage (B): {json.dumps(stages)}; "
             f"phase wgs_filt {out['seconds']:.1f} s")
    return out


def cli_rank(spec: dict) -> int:
    """``--cli-rank SPEC``: one process of a cluster (or, without
    ``--multihost`` in its arguments, a single-process sharded-dictionary
    run) through the port's
    command line, ``vargeno_tpu_torch.cli.main(spec["argv"])`` (what
    ``python -m vargeno_tpu_torch.cli`` runs), with its runner's
    construction (the placement), stream and VCF timed and their peak RSS
    sampled (``rehearse_wgs.stage_rss``), the vote kernel's launches
    counted, its cards' peak device memory and ``aux_all`` bytes read and
    its first attempt's ambiguous-exact numbers kept (``amb_summary``);
    prints one JSON line ``{"cli_rank": ...}`` under ``spec["tag"]``.
    Exits with the CLI's code."""
    sys.path.insert(0, ROOT)
    from vargeno_tpu_torch import cli
    from vargeno_tpu_torch.dist import multihost
    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn
    from vargeno_tpu_torch.tools.bench_scaling import peak_bytes
    from vargeno_tpu_torch.tools.rehearse_wgs import (record_first_attempt,
                                                      stage_rss)

    stages, secs, seen = {}, {}, {}

    def timed(cls, name, stage):
        fn = getattr(cls, name)

        def run(self, *a, **k):
            t0 = time.perf_counter()
            with stage_rss(stages, stage):
                got = fn(self, *a, **k)
            secs[stage] = time.perf_counter() - t0
            seen["runner"] = self
            if stage == "placement":
                seen["first"] = record_first_attempt(self)
            return got
        setattr(cls, name, run)

    for cls in ((multihost.MultiHostDictGenoRunner,
                 multihost.MultiHostGenoRunner)
                if "--multihost" in spec["argv"]
                else (ShardedDictGenoRunner,)):
        timed(cls, "__init__", "placement")
        timed(cls, "consume_fastq", "geno")
        timed(cls, "write_vcf", "vcf")
    vote_fn.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(spec["argv"])
    runner = seen["runner"]
    cards = list(dict.fromkeys(runner.mesh.devices))
    print(json.dumps({"cli_rank": dict(
        tag=spec["tag"],
        rank=runner.cluster.rank if hasattr(runner, "cluster") else 0, rc=rc,
        seconds=time.perf_counter() - t0, stage_s=secs,
        stage_peak_rss=stages, vote_launches=vote_fn.launches,
        cards=[str(c) for c in cards], reads=runner.n_reads,
        escalations=runner.n_escalations,
        overflow={k: v for k, v in runner.stats_totals.items()
                  if "overflow" in k and v},
        index_bytes=runner.device_bytes(), aux_bytes=aux_bytes(runner),
        card_peak_bytes=peak_bytes(cards),
        **amb_summary(runner, seen["first"]))}), flush=True)
    return rc


def run_cluster_leg(name: str, cmds, key: str, timeout: float, kill=None):
    """One cluster (a process a command, together), each process's output
    in a file of its own; ``kill = (checkpoint, kill_at, total)``
    SIGKILLs every process once the checkpoint's offset reaches kill_at
    (``endurance_wgs.kill_past``). Every process is killed once
    ``timeout`` seconds have passed. Returns (exit codes, each process's
    ``{key: ...}`` lines, the offset at the kill, seconds); a timeout
    fails the phase."""
    import tempfile
    import threading

    from vargeno_tpu_torch.tools.endurance_wgs import kill_past

    logs = [tempfile.TemporaryFile("w+") for _ in cmds]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                              text=True) for c, f in zip(cmds, logs)]
    expired = threading.Event()

    def expire():
        expired.set()
        for p in procs:
            if p.poll() is None:
                p.kill()

    timer = threading.Timer(timeout, expire)
    timer.start()
    try:
        killed_at = kill_past(procs, kill)
    finally:
        timer.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    seconds = time.perf_counter() - t0
    lines, tails = [], []
    for f in logs:
        f.seek(0)
        text = f.read()
        f.close()
        tails.append(text[-3000:])
        lines.append([json.loads(x)[key] for x in text.splitlines()
                      if x.startswith('{"%s"' % key)])
    rcs = [p.returncode for p in procs]
    if expired.is_set():
        raise RuntimeError(f"{name}: the cluster did not finish within "
                           f"{timeout} s:\n" + "\n".join(tails))
    if kill is None and any(rcs):
        raise RuntimeError(f"{name}: processes exited {rcs}:\n"
                           + "\n".join(tails))
    return rcs, lines, killed_at, seconds


def phase_wgs_cards(card: str, setup, prep_proc, stages: dict) -> dict:
    """``--wgs-cards`` (four cards): the headline scale with a shard a
    card (see the module's docstring). ``setup``: ``wgs_setup``'s
    result; ``prep_proc``: the running synthesis and build
    (``start_wgs_index``); ``stages``: each stage's peak RSS, filled
    here. (b) one process, D = 4 over cuda:0-3: the
    stream, no overflow, the vote launched, the first attempt's spill
    (required on a repeat-rich draw), the VCF, oracle spot parity, the
    bare vote launch on the first batch's records against the plain
    version; (c) four processes of one card over nccl through the command
    line, their VCF byte-identical to (b)'s; (d) kill / resume over the
    endurance reads, four processes over nccl from ``--mh-worker`` specs
    checkpointing every WGS4_CHECKPOINT_EVERY global batches: leg B
    SIGKILLed (every rank) at a checkpoint past half the stream, leg C's
    VCF byte-identical to leg A's. In (c) and in legs A and C of (d) every
    rank must have escalated as often as the others. Each part that fails
    is recorded and the rest still runs; the phase then fails."""
    import torch

    from vargeno_tpu_torch.dist.sharding import make_mesh
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.tools import rehearse_wgs

    n = torch.cuda.device_count()
    devices = WGS4_DEVICES.split(",")
    d, prefix, fq, host = setup
    vcf_in = os.path.join(d, "snps.vcf")
    out = dict(card=card, mb=WGS3_MB, snps=WGS3_SNPS, reads=WGS_READS,
               dup_share=WGS3_DUP_SHARE, batch_reads=BATCH,
               devices=WGS4_DEVICES, host=host)
    failures = []

    # (a) synthesis and the index build (started by the caller)
    t0 = time.perf_counter()
    prep = finish_tool(prep_proc, 3000, "wgs_cards",
                       ("index",)).get("index", {})
    out.update(prep=prep, prep_wait_s=time.perf_counter() - t0)
    stages.update({f"(a) {k}": v
                   for k, v in prep.get("stage_peak_rss", {}).items()})

    # (b) one process, a shard a card
    vcf_b = os.path.join(d, "wgs_cards_b.vcf")
    try:
        t0 = time.perf_counter()
        b_stages: dict = {}
        with rehearse_wgs.stage_rss(b_stages, "load"):
            index = store.load(prefix)
        load_s = time.perf_counter() - t0
        n_sites = int(index.sites.pos.shape[0])
        check_sites("wgs_cards", n_sites)
        if n < len(devices):
            raise AssertionError(f"wgs_cards: {n} cards")
        sharded, first = sharded_genome_checks(
            "wgs_cards", card, index, fq, make_mesh(devices=devices),
            rehearse_wgs.geno_config(BATCH), b_stages, vcf=(vcf_in, vcf_b))
        del index
        gc.collect()
        torch.cuda.empty_cache()
        stages.update({f"(b) {k}": v for k, v in b_stages.items()})
        out["b"] = dict(load_s=load_s, **sharded)
        check_spill("wgs_cards (b)", sharded)
        out["b"]["vote_on_step"] = time_vote_on_step("wgs_cards", card,
                                                     *first)
        del first
    except Exception as e:   # recorded; the phase fails at its end
        failures.append(f"(b): {e!r}")
        log("wgs_cards", f"FAILED (b): {e!r}")

    # (c) four processes of one card over nccl, the command line
    try:
        out["c"] = cli_cluster("wgs_cards (c)", card, prefix, fq, vcf_in,
                               os.path.join(d, "wgs_cards_c.vcf"), vcf_b, n,
                               stages)
    except Exception as e:
        failures.append(f"(c): {e!r}")
        log("wgs_cards", f"FAILED (c): {e!r}")

    # (d) kill / resume, four processes over nccl
    try:
        out["d"] = cluster_endurance(
            "wgs_cards (d)", card, prefix,
            os.path.join(d, f"reads_{WGS_EXTRA_READS}.fq"), vcf_in, d,
            WGS_EXTRA_READS, WGS4_CHECKPOINT_EVERY, dict(
                batch_reads=BATCH, max_read_len=128, max_kmers_per_read=4,
                events_per_read=24),   # rehearse_wgs.geno_config's
            n, stages)
    except Exception as e:
        failures.append(f"(d): {e!r}")
        log("wgs_cards", f"FAILED (d): {e!r}")

    over = {k: v for k, v in stages.items() if v >= host["mem_total"]}
    if over:
        failures.append(f"stages at the host's MemTotal "
                        f"({host['mem_total']} B): {over}")
    out["stage_peak_rss"] = stages
    log("wgs_cards", f"[{card}] peak RSS by stage (B): {json.dumps(stages)}")
    if failures:
        raise AssertionError("wgs_cards: " + "; ".join(failures))
    return out


def cli_cluster(tag: str, card: str, prefix: str, fq: str, vcf_in: str,
                vcf_out: str, want_vcf: str, n: int, stages: dict) -> dict:
    """n processes of one card each through the command line (``geno
    ... --multihost --sharded-dict --mesh n``, each in ``--cli-rank``, the
    cards the CLI's default): every rank's stages, vote launches and
    memory, no overflow, the same escalations on every rank, and the VCF
    byte-identical to ``want_vcf``."""
    port = free_port()
    cmds = [worker_command("--cli-rank", dict(tag=tag, argv=[
        "geno", prefix, fq, vcf_in, vcf_out, "--device", DEVICE,
        "--multihost", f"localhost:{port}", "--num-processes", str(n),
        "--process-id", str(i), "--dist-backend", WGS4_BACKEND, "--mesh",
        str(n), "--sharded-dict", "--batch-reads", str(BATCH)]))
        for i in range(n)]
    _, lines, _, wall_s = run_cluster_leg(tag, cmds, "cli_rank", 1500)
    ranks = [x[0] for x in lines]
    with open(vcf_out, "rb") as f, open(want_vcf, "rb") as g:
        same = f.read() == g.read()

    def per_rank(stage):
        return [round(r["stage_s"][stage], 2) for r in ranks]
    for r in ranks:
        stages.update({f"{tag} rank {r['rank']} {k}": v
                       for k, v in r["stage_peak_rss"].items()})
    log(tag, f"[{card}] {n} processes x 1 card over {WGS4_BACKEND} (the "
             f"CLI): VCF "
             + ("byte-identical to " if same else "DIFFERS from ")
             + f"{os.path.basename(want_vcf)}; per rank: placement "
             f"{per_rank('placement')} s, stream {per_rank('geno')} s, VCF "
             f"{per_rank('vcf')} s, vote launches "
             f"{[r['vote_launches'] for r in ranks]}, cards "
             f"{[r['cards'] for r in ranks]}, index bytes "
             f"{[r['index_bytes'] for r in ranks]}, peak device memory "
             f"{[r['card_peak_bytes'] for r in ranks]} B, peak RSS "
             f"{[r['stage_peak_rss'] for r in ranks]} B, aux_all "
             f"{[r['aux_bytes'] for r in ranks]} B; {ranks[0]['reads']} "
             f"reads, escalations {[r['escalations'] for r in ranks]}, "
             f"first attempt's amb_overflow "
             f"{[r['first_amb_overflow'] for r in ranks]}; cluster wall "
             f"{wall_s:.1f} s")
    if not same or len(ranks) != n or any(
            r["overflow"] or r["vote_launches"] <= 0 or r["rc"]
            for r in ranks) or len({r["escalations"] for r in ranks}) != 1:
        raise AssertionError(f"{tag}: VCF equal {same}, ranks {ranks}")
    return dict(wall_s=wall_s, vcf_equal=same, ranks=ranks)


def cluster_endurance(tag: str, card: str, prefix: str, fq: str,
                      vcf_in: str, d: str, total: int, every: int,
                      config: dict, n: int, stages: dict) -> dict:
    """Kill / resume across processes over the ``total`` reads of ``fq``:
    legs A (uninterrupted), B (checkpointing every ``every`` global
    batches, every rank SIGKILLed once a checkpoint at or past half the
    stream is on disk) and C (the same cluster again, resumed), n
    processes of one card over nccl from ``--mh-worker`` specs (the CLI
    checkpoints every 64 batches only). C must resume from the kill's
    checkpoint and write leg A's VCF byte for byte, with no overflow, the
    vote kernel launched in every process of A and C and the same
    escalations on every rank of a leg."""
    from vargeno_tpu_torch.tools.endurance_wgs import checkpoint_offset

    name = tag.split()[0]
    ck = os.path.join(d, f"{name}_ck")
    for ext in (".npz", ".json"):
        if os.path.exists(ck + ext):
            os.remove(ck + ext)
    kill_at = total // 2

    def leg(k, out_vcf, checkpoint=None, kill=None):
        port = free_port()
        run = dict(tag=k, dict=True, queued=True, out=out_vcf)
        if checkpoint:
            run.update(checkpoint=checkpoint, checkpoint_every=every)
        cmds = [worker_command("--mh-worker", dict(
            prefix=prefix, fq=fq, vcf_in=vcf_in, config=config, timeout=300,
            runs=[run], port=port, world=n, rank=r, backend=WGS4_BACKEND,
            devices=[f"{DEVICE}:{r}"])) for r in range(n)]
        rcs, lines, killed_at, wall_s = run_cluster_leg(
            f"{tag} leg {k}", cmds, "mh_run", 1200, kill)
        ranks = [x[0] for x in lines if x]
        for r in ranks:
            stages.update({f"{tag} leg {k} rank {r['rank']} {s}": v
                           for s, v in r["stage_peak_rss"].items()})
        got = dict(wall_s=wall_s, rcs=rcs, killed_at=killed_at,
                   ranks=[{f: r[f] for f in (
                       "rank", "reads", "geno_s", "setup_s", "load_s",
                       "vcf_s", "resumed_from", "vote_launches",
                       "escalations", "batches", "retry_batches",
                       "overflow", "index_bytes", "card_peak_bytes",
                       "aux_bytes", "amb_hits_a_read", "first_amb_overflow",
                       "amb_hits_per_read", "cards", "stage_peak_rss")}
                          for r in ranks])
        if ranks:
            log(tag, f"[{card}] leg {k}: wall {wall_s:.1f} s; per rank: "
                     f"load {[round(r['load_s'], 2) for r in ranks]} s, "
                     f"placement {[round(r['setup_s'], 2) for r in ranks]}"
                     f" s, stream {[round(r['geno_s'], 2) for r in ranks]} "
                     f"s ({ranks[0]['reads']} reads, resumed from "
                     f"{ranks[0]['resumed_from']}), escalations "
                     f"{[r['escalations'] for r in ranks]}, first "
                     f"attempt's amb_overflow "
                     f"{[r['first_amb_overflow'] for r in ranks]}, vote "
                     f"launches {[r['vote_launches'] for r in ranks]}, "
                     f"aux_all {[r['aux_bytes'] for r in ranks]} B, peak "
                     f"device "
                     f"memory {[r['card_peak_bytes'] for r in ranks]} B, "
                     f"index {[r['index_bytes'] for r in ranks]} B")
        return got

    full = os.path.join(d, f"{name}_full.vcf")
    resumed = os.path.join(d, f"{name}_resumed.vcf")
    legs = {"A": leg("A", full)}
    legs["B"] = leg("B", resumed, ck, kill=(ck, kill_at, total))
    offset = checkpoint_offset(ck)
    log(tag, f"[{card}] leg B: exit codes {legs['B']['rcs']}, SIGKILL at "
             f"checkpoint offset {legs['B']['killed_at']} (kill point "
             f"{kill_at})")
    if legs["B"]["killed_at"] is None or any(
            rc != -signal.SIGKILL for rc in legs["B"]["rcs"]) \
            or offset is None or not kill_at <= offset < total:
        raise AssertionError(f"{tag}: leg B was not killed past the kill "
                             f"point: {legs['B']}, checkpoint {offset}")
    legs["C"] = leg("C", resumed, ck)
    with open(full, "rb") as f, open(resumed, "rb") as g:
        a, c = f.read(), g.read()
    ok = (a == c and all(r["resumed_from"] == offset
                         for r in legs["C"]["ranks"]))
    for k in "AC":
        if len(legs[k]["ranks"]) != n or any(
                r["overflow"] or r["vote_launches"] <= 0
                for r in legs[k]["ranks"]) or len(
                    {r["escalations"] for r in legs[k]["ranks"]}) != 1:
            ok = False
    log(tag, f"[{card}] kill / resume over {total} reads, {n} processes "
             f"over {WGS4_BACKEND}: leg C resumed from {offset} and its VCF "
             f"is " + ("byte-identical to leg A's" if a == c else
                       "DIFFERENT from leg A's")
             + f" ({len(a)} B); legs A / B / C {legs['A']['wall_s']:.1f} / "
             f"{legs['B']['wall_s']:.1f} / {legs['C']['wall_s']:.1f} s")
    if not ok:
        raise AssertionError(f"{tag}: resume failed: {legs}")
    return dict(reads=total, kill_at=kill_at, killed_at_offset=offset,
                checkpoint_every=every, vcf_bytes=len(a), legs=legs)


def phase_cards(card: str) -> dict:
    """``--all-cards``: the 48 Mb workload, untuned, on every visible card
    (n >= 2), two passes each (the second warm, timed only), every first
    pass's VCF byte-identical to the one-card hash-table pass's, no
    overflow, the vote kernel launched in every process. One process
    driving the n cards from one host thread (the replicated index: shard
    steps in turn) or from a thread a shard (the sharded dictionary),
    against n processes of one card each (``dist/multihost.py``): the
    replicated index over nccl (no data collective: only the launch rate
    differs), the sharded dictionary over nccl and over gloo (the same
    processes; only the all-to-all transport differs). Then the scaling
    tools (``cards_scaling``), the sharded dictionary on n processes of
    one card through the command line (``cli_cluster``, its VCF equal to
    the one-card pass's) and a kill / resume across n processes over the
    scaling workload's reads (``cluster_endurance``, a checkpoint every
    CARDS_CHECKPOINT_EVERY global batches); a failure among these three
    is recorded, the others still run, and the phase then fails."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        raise RuntimeError(f"--all-cards needs 2 or more cards, {n} visible")

    # the scaling workload's dataset and index, made beside the passes
    # below (host only; those passes are too short to rank)
    scaling_prep = start_session([
        sys.executable, "-c", "import sys, chip_smoke; "
        f"sys.exit(chip_smoke.prepare_scaling({n}))"])
    try:
        return cards_passes(card, n, scaling_prep)
    finally:
        if scaling_prep.poll() is None:
            os.killpg(scaling_prep.pid, signal.SIGKILL)
            scaling_prep.wait()


def cards_passes(card: str, n: int, scaling_prep) -> dict:
    """Phase cards on n cards (``phase_cards``); ``scaling_prep`` makes the
    scaling workload meanwhile."""
    import torch

    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
    from vargeno_tpu_torch.dist.sharding import ShardedGenoRunner, make_mesh
    from vargeno_tpu_torch.engine.geno import GenoRunner
    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.io.fastq import autosize_shapes
    from vargeno_tpu_torch.kernels.vote import vote_scan_records as vote_fn
    from vargeno_tpu_torch.tools import bench

    wl = real_workload()
    d, prefix, vcf, fq = wl.cache, wl.prefix, wl.vcf, wl.fq
    bench.build_dataset(wl)
    bench.build_index(wl)
    L, K = autosize_shapes(fq)
    cfg = dict(batch_reads=BATCH, max_read_len=L, max_kmers_per_read=K,
               ht_target_load=HT_LOAD)
    index = store.load(prefix)
    ref_vcf = os.path.join(d, "cards_ref.vcf")
    out = {"cards": n}

    def drive(tag, make):
        """Two passes of one single-process runner; the first pass's VCF
        is written and held against the first runner's (the one-card
        pass), the second pass is timed only."""
        gc.collect()
        torch.cuda.empty_cache()
        for i in range(n):
            torch.cuda.reset_peak_memory_stats(i)
        def sync():
            for i in range(n):
                torch.cuda.synchronize(i)
        t0 = time.perf_counter()
        runner = make()
        sync()
        setup_s = time.perf_counter() - t0
        pass_s = []
        for k in range(2):
            vote_fn.launches = 0
            t0 = time.perf_counter()
            runner.consume_fastq(fq)
            sync()
            pass_s.append(time.perf_counter() - t0)
            if k == 0:
                launches = vote_fn.launches
                check_no_overflow(runner, f"cards/{tag}")
                path = os.path.join(d, f"cards_{len(out)}.vcf")
                runner.write_vcf(vcf, path)
                if len(out) == 1:   # the one-card pass: the reference
                    os.replace(path, ref_vcf)
                else:
                    with open(path) as f, open(ref_vcf) as g:
                        if f.read() != g.read():
                            raise AssertionError(f"cards/{tag}: VCF differs "
                                                 f"from the one-card pass's")
        if launches <= 0:
            raise AssertionError(f"cards/{tag}: the vote kernel was never "
                                 f"launched")
        peaks = [torch.cuda.max_memory_allocated(i) for i in range(n)]
        out[tag] = dict(reads_s=[runner.n_reads / 2 / t for t in pass_s],
                        pass_s=pass_s, setup_s=setup_s,
                        vote_launches=launches, peak_bytes=peaks)
        log("cards", f"[{card}] {tag}: {runner.n_reads // 2} reads a pass, "
                     f"passes {[round(t, 4) for t in pass_s]} s = "
                     f"{[round(runner.n_reads / 2 / t, 1) for t in pass_s]}"
                     f" reads/s (setup {setup_s:.2f} s excluded); vote "
                     f"launches {launches}; peak device memory per card "
                     f"{peaks} B")
        del runner

    cards = [f"{DEVICE}:{i}" for i in range(n)]
    drive("hash table, 1 card", lambda: GenoRunner(
        index, GenoConfig(**cfg), device=cards[0]))
    drive(f"replicated index, 1 process, {n} cards",
          lambda: ShardedGenoRunner(index, make_mesh(devices=cards),
                                    GenoConfig(**cfg)))
    drive(f"sharded dictionary, 1 process, {n} cards (a thread a shard)",
          lambda: ShardedDictGenoRunner(index, make_mesh(devices=cards),
                                        GenoConfig(**cfg)))
    del index
    gc.collect()
    torch.cuda.empty_cache()

    # n processes of one card each: the replicated index and the sharded
    # dictionary over nccl, the sharded dictionary over gloo
    for backend, kinds in (("nccl", ("replicated index",
                                     "sharded dictionary")),
                           ("gloo", ("sharded dictionary",))):
        common = dict(prefix=prefix, fq=fq, vcf_in=vcf, config=cfg,
                      timeout=300, runs=[dict(
                          tag=kind, dict=kind == "sharded dictionary",
                          queued=True, passes=2,
                          out=os.path.join(d, f"cards_{backend}_{i}.vcf"))
                          for i, kind in enumerate(kinds)])
        t0 = time.perf_counter()
        got = finish_cluster(start_cluster(
            f"{n} processes over {backend}", backend,
            [[c] for c in cards], common), 900)
        wall_s = time.perf_counter() - t0
        for run in common["runs"]:
            lines = got.get(run["tag"], [])
            tag = f"{run['tag']}, {n} processes x 1 card, {backend}"
            if len(lines) != n:
                raise AssertionError(f"cards/{tag}: {len(lines)} of {n} "
                                     f"processes reported")
            with open(run["out"]) as f, open(ref_vcf) as g:
                if f.read() != g.read():
                    raise AssertionError(f"cards/{tag}: VCF differs from "
                                         f"the one-card pass's")
            for g in lines:
                if g["overflow"] or g["vote_launches"] <= 0:
                    raise AssertionError(f"cards/{tag}: rank {g['rank']}: "
                                         f"{g}")
            pass_s = [max(g["pass_s"][k] for g in lines) for k in range(2)]
            reads = lines[0]["reads"]
            out[tag] = dict(
                reads_s=[reads / t for t in pass_s], pass_s=pass_s,
                setup_s=[g["setup_s"] for g in lines],
                vote_launches=[g["vote_launches"] for g in lines],
                peak_bytes=[g["peak_bytes"] for g in lines],
                index_bytes=[g["index_bytes"] for g in lines],
                retry_batches=lines[0]["retry_batches"],
                batches=lines[0]["batches"])
            log("cards", f"[{card}] {tag}: VCF byte-identical to the "
                         f"one-card pass's; passes (the slowest process) "
                         f"{[round(t, 4) for t in pass_s]} s = "
                         f"{[round(reads / t, 1) for t in pass_s]} reads/s; "
                         f"{lines[0]['batches'] - lines[0]['retry_batches']}"
                         f" forward + {lines[0]['retry_batches']} lockstep "
                         f"retry batches; per process: vote launches "
                         f"{out[tag]['vote_launches']}, peak device memory "
                         f"{out[tag]['peak_bytes']} B, index "
                         f"{out[tag]['index_bytes']} B, setup "
                         f"{[round(t, 2) for t in out[tag]['setup_s']]} s; "
                         f"cluster wall {wall_s:.1f} s")

    # the scaling tools, then n processes through the CLI and a kill /
    # resume across n processes: each recorded, the phase failing after
    failures, stages = [], {}
    swl = scaling_workload(n)
    for key, fn, args in (
            ("scaling", cards_scaling, (card, n, scaling_prep)),
            ("cli", cli_cluster, (
                "cards (cli)", card, prefix, fq, vcf,
                os.path.join(d, "cards_cli.vcf"), ref_vcf, n, stages)),
            ("kill_resume", cluster_endurance, (
                "cards (kill/resume)", card, swl.prefix, swl.fq, swl.vcf,
                swl.cache, swl.reads, CARDS_CHECKPOINT_EVERY, cfg, n,
                stages))):
        try:
            out[key] = fn(*args)
        except Exception as e:   # recorded; the phase fails at its end
            failures.append(f"{key}: {e!r}")
            log("cards", f"FAILED {key}: {e!r}")
    out["stage_peak_rss"] = stages
    if failures:
        raise AssertionError("cards: " + "; ".join(failures))
    return out


def scaling_workload(n: int):
    """``--all-cards``' scaling workload: bench.py's genome and SNPs with
    enough reads for CARDS_SCALING_BATCHES + 1 global batches of BATCH
    reads a card at the largest D of n cards, in a cache of its own."""
    from vargeno_tpu_torch.tools import bench_scaling as bs
    from vargeno_tpu_torch.tools.bench import Workload

    reads = BATCH * max(bs.sizes_upto(n)) * (CARDS_SCALING_BATCHES + 1)
    return Workload(
        cache=os.path.join(CACHE, f"scaling{GENOME_MB}mb_{N_SNPS}snp_"
                                  f"{reads}r"),
        mb=GENOME_MB, snps=N_SNPS, reads=reads, batch=BATCH)


def prepare_scaling(n: int) -> int:
    """The scaling workload's dataset and index (the bench tool's
    functions), in a process of its own; prints ``{"scaling_prep":
    ...}``: the seconds of both."""
    from vargeno_tpu_torch.tools import bench

    wl = scaling_workload(n)
    t0 = time.perf_counter()
    bench.build_dataset(wl)
    dataset_s = time.perf_counter() - t0
    bench.build_index(wl)
    print(json.dumps({"scaling_prep": dict(
        reads=wl.reads, dataset_s=dataset_s,
        index_s=time.perf_counter() - t0 - dataset_s)}), flush=True)
    return 0


def cards_scaling(card: str, n: int, prep) -> dict:
    """``--all-cards``: the scaling tools on bench.py's genome and SNPs
    (48 Mb, 500,000 SNPs, the bench's seed) with enough reads for
    CARDS_SCALING_BATCHES + 1 global batches of 32,768 reads a card at the
    largest D, in a cache of its own: ``bench_scaling``'s ``run_point`` at
    D = 1, 2, 4, ... up to n cards (routed from 2), then
    ``bench_scaling_mh``'s clusters over nccl, n processes x 1 card and
    n / 2 x 2, both modes, CARDS_SCALING_BATCHES batches a point. Each
    point: no overflow, the vote kernel launched in every process, the
    window's reads; a single-process point's efficiency as the JAX tool
    takes it (against the mode's first point: the routed mode starts at
    D = 2), a multi-process point's against one card (the dp point at D =
    1)."""
    import argparse

    from vargeno_tpu_torch.index import store
    from vargeno_tpu_torch.tools import bench_scaling as bs
    from vargeno_tpu_torch.tools import bench_scaling_mh as bsm

    batches = CARDS_SCALING_BATCHES
    sizes = bs.sizes_upto(n)
    wl = scaling_workload(n)
    reads = wl.reads
    t0 = time.perf_counter()
    made = finish_tool(prep, 1200, "cards", ("scaling_prep",))
    prep_s = time.perf_counter() - t0
    log("cards", f"scaling dataset ({reads} reads) and index: "
                 f"{made.get('scaling_prep')}; the rest of their wait "
                 f"{prep_s:.1f} s")
    index = store.load(wl.prefix)
    cfg = bs.point_config(BATCH)
    points: dict = {m: [] for m in bs.MODES}
    for mode in bs.MODES:
        for d in sizes:
            if mode == "routed" and d == 1:
                continue   # routing needs >= 2 shards
            p, runner = bs.run_point(index, wl.fq, mode,
                                     bs.mesh_devices(d, False), cfg, batches)
            del runner
            bs.release()
            points[mode].append(p)
            bs.with_efficiency(points[mode])
            check_scaling_point(f"cards/scaling/{mode}/{d}", p, batches,
                                BATCH)
            log("cards", f"[{card}] bench_scaling.run_point, 1 process: "
                         + scaling_line(p))
    del index
    gc.collect()
    one_card = points["dp"][0]["reads_per_sec"]
    mh = []
    layouts = [(n, 1)] + ([(n // 2, 2)] if n >= 4 and n % 2 == 0 else [])
    for P, K in layouts:
        args = argparse.Namespace(procs=P, devices_per_proc=K,
                                  batches=batches, batch_reads=BATCH,
                                  cpu=False, dist_backend="nccl", cards=None)
        cards = bsm.cluster_cards(args)
        for mode in bs.MODES:
            t0 = time.perf_counter()
            p = bsm.run_cluster(args, mode, cards, "nccl", wl.prefix, wl.fq)
            p["wall_s"] = time.perf_counter() - t0
            p["efficiency"] = round(p["reads_per_sec"] / (
                one_card * p["devices"]), 3)
            check_scaling_point(f"cards/scaling_mh/{mode}/{P}x{K}", p,
                                batches, BATCH)
            log("cards", f"[{card}] bench_scaling_mh: " + scaling_line(p)
                + f" (efficiency against one card: the dp point at D = 1, "
                  f"{one_card} reads/s); every rank's seconds "
                  f"{[round(t, 4) for t in p['rank_seconds']]}; cluster "
                  f"wall {p['wall_s']:.1f} s")
            mh.append(p)
    return dict(reads=reads, batches=batches, batch_reads=BATCH,
                prep=made.get("scaling_prep"), prep_wait_s=prep_s,
                points=points["dp"] + points["routed"], multiprocess=mh)


def kernels_line(vote_t, vote_err, vote_launches, gather_t, gather_err,
                 gather_launches, **vote_extra) -> dict:
    """The kernels line: each kernel against its plain version at its main
    shape, as the kernel phases timed it, with its launches on this run's
    main path (and the vote's elsewhere, ``vote_extra``)."""
    return {"kernels": [
        {"name": "vote_scan", "route": "cuda",
         "source": "vargeno_tpu_torch/csrc/vote.cu",
         "replaces": "vargeno_tpu/engine/pallas_vote.py:26",
         "launches": vote_launches, "max_abs_err": vote_err,
         "shape": "(E, B, C) = " + str(KERNEL_SHAPES[0][:3]),
         **vote_t[KERNEL_SHAPES[0][:3]], "library_ms": None,
         "ms_of": "the records entry (zero one word, launch)",
         **vote_extra},
        {"name": "gather_rows_sum", "route": "cuda",
         "source": "vargeno_tpu_torch/csrc/gather.cu",
         "replaces": "tools/bench_gather.py:245",
         "launches": gather_launches, "max_abs_err": gather_err,
         "shape": "(N, R, W) = " + str(GATHER_MAIN),
         **gather_t[GATHER_MAIN],
         "ms_of": "the wrapper (zero one word, launch the kernel the "
                  "library picks: see kernel)"}]}


def four_cards(card: str, t_start: float, with_cards: bool) -> int:
    """``--wgs-cards`` (and ``--all-cards --wgs-cards``): the headline
    scale's synthesis and build start at once in a session of their own;
    beside them run what needs no quiet host: the kernel phases, the
    gather bench, phase scaling (the tools' one-card checks) and, with
    ``--all-cards``, phase cards (its reads/s then taken beside the
    build); then phase wgs_cards. A failed phase is recorded and the rest
    still runs; the run then exits 1."""
    import torch

    n = torch.cuda.device_count()
    if n < len(WGS4_DEVICES.split(",")):
        print(f"error: --wgs-cards needs {len(WGS4_DEVICES.split(','))} "
              f"visible cards, {n} visible", file=sys.stderr)
        return 1
    setup = wgs_setup("wgs_cards", card, WGS4_DEVICES)
    prep = start_wgs_index()
    got: dict = {}
    failures = []

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            got[name] = fn(*args)
        except Exception as e:   # recorded; the run exits 1 at its end
            failures.append(f"{name}: {e!r}")
            log("done", f"phase {name} FAILED: {e!r}")
        log("done", f"phase {name} {time.perf_counter() - t0:.1f} s")

    stages: dict = {}
    try:
        timed("kernel (vote)", phase_kernel_vote)
        timed("kernel (gather)", phase_kernel_gather)
        timed("bench", phase_bench, card)
        timed("scaling", phase_scaling, card)
        if with_cards:
            timed("cards", phase_cards, card)
        timed("wgs_cards", phase_wgs_cards, card, setup, prep, stages)
    finally:   # on a failure, stop the build if it still runs
        if prep.poll() is None:
            os.killpg(prep.pid, signal.SIGKILL)
            prep.wait()
    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    if failures:
        print("error: " + "; ".join(failures), file=sys.stderr)
        return 1
    w = got["wgs_cards"]
    if with_cards:
        print(json.dumps({"cards": {"card": card, **got["cards"]}}),
              flush=True)
    print(json.dumps({"scaling": got["scaling"]}), flush=True)
    print(json.dumps({"wgs_cards": w}), flush=True)
    vote_t, vote_err = got["kernel (vote)"]
    gather_t, gather_err = got["kernel (gather)"]
    print(json.dumps(kernels_line(
        vote_t, vote_err, w["b"]["vote_launches"], gather_t, gather_err,
        got["bench"][1],
        launches_of="wgs_cards (b): the 262,144-read pass at D = 4 in one "
                    "process",
        wgs_cards_batch_raw_launch_ms=w["b"]["vote_on_step"]["raw_ms"],
        wgs_cards_batch_plain_ms=w["b"]["vote_on_step"]["plain_ms"],
        wgs_cards_batch_bound_ms=w["b"]["vote_on_step"]["bound_ms"],
        launches_per_process={
            "(b) spot parity": w["b"]["spot"]["vote_launches"],
            "(c) 4 processes (CLI)": [r["vote_launches"]
                                      for r in w["c"]["ranks"]],
            **{f"(d) leg {k}": [r["vote_launches"]
                                for r in w["d"]["legs"][k]["ranks"]]
               for k in "AC"}})), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    argv = sys.argv[1:]
    parent = None
    if len(argv) == 2 and argv[0] in ("--parent", "--step-ops-of",
                                      "--routed-step-ops-of", "--mh-worker",
                                      "--cli-rank"):
        parent = argv[1]
    elif argv and sorted(argv) not in (
            ["--all-cards"], ["--wgs"], ["--wgs-cards"],
            ["--all-cards", "--wgs-cards"], ["--repeats", "--wgs"],
            ["--repeats", "--wgs-cards"], ["--filt", "--wgs"]):
        print("usage: chip_smoke.py [--parent DIR | --all-cards | --wgs "
              "[--repeats | --filt] | --wgs-cards [--repeats] | "
              "--all-cards --wgs-cards]", file=sys.stderr)
        return 2
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
    if argv and argv[0] == "--mh-worker":
        return mh_worker(json.loads(argv[1]))
    if "--repeats" in argv:   # the whole genome, repeat-rich
        global WGS3_DUP_SHARE
        WGS3_DUP_SHARE = REPEATS_DUP_SHARE
        argv.remove("--repeats")
    if argv and argv[0] == "--cli-rank":
        return cli_rank(json.loads(argv[1]))
    if argv and argv[0] in ("--step-ops-of", "--routed-step-ops-of"):
        return step_ops_of(parent, routed=argv[0] == "--routed-step-ops-of")
    if parent:
        parent = inside_checkout(parent)
    sys.path.insert(0, ROOT)
    try:
        from vargeno_tpu_torch import native
        from vargeno_tpu_torch.kernels import _build, gather, vote
        from vargeno_tpu_torch.tools.bench import card_line
    except ImportError as e:
        print(f"error: the vargeno_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    card = card_line()
    print(card, flush=True)
    log("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                  f"numpy {np.__version__}, "
                  f"{torch.cuda.get_device_name(0)} x "
                  f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    vote.load_library()
    gather.load_library()
    if not native.available():
        raise RuntimeError("native host library failed to build (g++)")
    log("build", f"vote + gather kernels (nvcc sm_90a) and the native host "
                 f"library (g++) ready in {time.perf_counter() - t0:.2f} s")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"ptxas {name}: " + line.strip())

    if "--wgs-cards" in argv:
        return four_cards(card, t_start, "--all-cards" in argv)

    if argv == ["--all-cards"]:
        cards = phase_cards(card)
        log("done", f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"cards": {"card": card, **cards}}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if sorted(argv) == ["--filt", "--wgs"]:
        wgs_filt = phase_wgs_filt(card)
        log("done", f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"wgs_filt": wgs_filt}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if argv == ["--wgs"]:
        wgs = phase_wgs(card)
        log("done", f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"wgs": wgs}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        got = fn(*args)
        log("done", f"phase {name} {time.perf_counter() - t0:.1f} s")
        return got

    # phase genome (a) and then (e) run beside the phases that time no
    # reads/s; (e) takes the card only once the kernel and bench phases
    # are over
    go = os.path.join(genome_dir(), "go")
    if os.path.exists(go):
        os.remove(go)
    bg = start_genome_background(go)
    real_bg = start_real_prep()   # the real phase's dataset and index too
    repeats_bg = start_repeats_prep()   # and phase repeats' with its oracle
    try:
        vote_t, vote_err = timed("kernel (vote)", phase_kernel_vote)
        gather_t, gather_err = timed("kernel (gather)", phase_kernel_gather)
        rates, gather_launches = timed("bench", phase_bench, card)
        open(go, "w").close()
        timed("golden", phase_golden)
        timed("mesh", phase_mesh)
        # phase scaling runs beside the end of phase fuzz's big seed
        fuzz = timed("fuzz", phase_fuzz, card,
                     lambda: timed("scaling", phase_scaling, card))
        scaling = fuzz.pop("beside")
        real_prep = timed("real's dataset and index, the rest of their "
                          "wait", finish_tool, real_bg, 600, "real",
                          ("real_prep",))["real_prep"]
        repeats_prep = timed("repeats' dataset, index and oracle, the "
                             "rest of their wait", finish_tool, repeats_bg,
                             600, "repeats",
                             ("repeats_prep",))["repeats_prep"]
        genome_bg = timed("genome (a) and (e), the rest of their wait",
                          finish_tool, bg, 900, "genome",
                          ("index", "endurance"))
    finally:   # on a failure, stop what still runs
        for p in (bg, real_bg, repeats_bg):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    real = timed("real", phase_real, card, rates, parent, real_prep)
    pipeline = timed("pipeline", phase_pipeline, card)
    geno_bench = timed("geno_bench", phase_geno_bench, card, rates, real)
    routed = timed("routed", phase_routed, card, real)
    mh = timed("multihost", phase_multihost, card, routed)
    genome = timed("genome", phase_genome, card, genome_bg)
    repeats = timed("repeats", phase_repeats, card, repeats_prep)

    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"mesh": {
        "card": card, "workload": f"{GENOME_MB} Mb, {N_SNPS} SNPs, "
                                  f"{N_READS} reads, batch_reads {BATCH}",
        "hash_table": {"reads_s": real["rate"], "peak_bytes": real["peak"],
                       "index_bytes": real["dix_bytes"],
                       "step_ops": real["step_ops"]},
        **routed, "multihost": mh}}), flush=True)
    print(json.dumps({"geno_bench": geno_bench}), flush=True)
    print(json.dumps({"fuzz": fuzz}), flush=True)
    print(json.dumps({"scaling": scaling}), flush=True)
    print(json.dumps({"genome": genome}), flush=True)
    print(json.dumps({"repeats": repeats}), flush=True)
    print(json.dumps({"pipeline": pipeline}), flush=True)
    main_shape = str(KERNEL_SHAPES[0][:3])
    before = real["parent"]
    print(json.dumps({"kernels": [
        {"name": "vote_scan", "route": "cuda",
         "source": "vargeno_tpu_torch/csrc/vote.cu",
         "replaces": "vargeno_tpu/engine/pallas_vote.py:26",
         "launches": real["launches"], "max_abs_err": vote_err,
         "bench_launches": geno_bench["bench"]["vote_launches"],
         "cohort_launches": geno_bench["cohort"]["vote_launches"],
         "routed_launches": {k: routed[k]["vote_launches"]
                             for k in ("D1", "D2")},
         "multihost_launches_per_process": {
             "48 Mb, 2 processes": mh["mb48"]["vote_launches"],
             **{f"mini {k} {t}": v for k, runs in mh["mini"].items()
                for t, v in runs.items()}},
         "fuzz_launches": {k: v["vote_launches"]
                           for k, v in fuzz["runners"].items()},
         "scaling_launches_per_process": {
             f"{src} {p['mode']} D = {p['devices']}": p["vote_launches"]
             for src, pts in (("bench_scaling --devices 1", scaling["tool"]),
                              ("run_point on cuda:0 twice",
                               scaling["cuda0_twice"]),
                              ("bench_scaling_mh 2 x 1 gloo",
                               scaling["mh_gloo_2x1"]))
             for p in pts},
         "genome_launches": {
             "hash table": genome["hash_table"]["vote_launches"],
             "sharded dictionary, D = 1":
                 genome["sharded_d1"]["vote_launches"],
             "spot parity": genome["sharded_d1"]["spot"]["vote_launches"],
             **{f"endurance leg {k}": v["vote_launches"]
                for k, v in genome["endurance"]["legs"].items()
                if v["vote_launches"] is not None}},
         "genome_batch_raw_launch_ms": genome["vote_on_step"]["raw_ms"],
         "repeats_launches": {k: v["vote_launches"]
                              for k, v in repeats["runs"].items()},
         "pipeline_launches": {
             **{k: v["vote_launches"] for k, v in pipeline["points"].items()},
             "forced escalation":
                 pipeline["forced_escalation"]["vote_launches"],
             "sharded dictionary D = 2":
                 pipeline["sharded_dict"]["vote_launches"],
             **{f"2 processes {k}": v["vote_launches"]
                for k, v in pipeline["multihost"].items()}},
         "shape": "(E, B, C) = " + str(KERNEL_SHAPES[0][:3]),
         **vote_t[KERNEL_SHAPES[0][:3]], "library_ms": None,
         "ms_before": before["eb_entry_ms"][main_shape] if before else None,
         "ms_before_of": "this run: the (E, B) entry of the --parent "
                         "checkout, which its step called (null without "
                         "--parent)",
         "ms_of": "the records entry (zero one word, launch)",
         "real_batch_raw_launch_ms": real["real_raw_ms"],
         "real_step_kernel_us": real["real_kernel_us"],
         "kernel_us": real["kernel_us"][main_shape],
         "kernel_us_before": (before["eb_vote_kernel_us"][main_shape]
                              if before else None),
         "step_ops_before": before["step_ops"] if before else None,
         "device_ops_a_step": real["step_ops"],
         "device_ops_a_call": real["vote_call_ops"]},
        {"name": "gather_rows_sum", "route": "cuda",
         "source": "vargeno_tpu_torch/csrc/gather.cu",
         "replaces": "tools/bench_gather.py:245",
         "launches": gather_launches, "max_abs_err": gather_err,
         "shape": "(N, R, W) = " + str(GATHER_MAIN),
         **gather_t[GATHER_MAIN],
         "ms_before_of": "this run: the direct-load kernel, which was the "
                         "only one before, named outright",
         "ms_of": "the wrapper (zero one word, launch the kernel the "
                  "library picks: see kernel)"}]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
