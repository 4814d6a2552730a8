"""Jax-free copy of ``vargeno_tpu/config.py``, holding only the fields the
port reads (the JAX package's Pallas knobs and its retired prefilter's are
left out; the host dispatch pipeline's -- ``pre_encode``,
``pipeline_depth``, ``group_size`` -- are here, read by
``engine/geno.py``).

Runtime configuration of index build and genotyping.

The reference implementation (medvedevgroup/vargeno) hard-codes all of these as
compile-time ``#define``s (reference: src/vartype.h:6-17,27,93,103;
src/generate_bf.h:201-209; src/qv.cc:57-58).  Here they are runtime dataclass
fields so a single build supports every configuration, with defaults chosen to
reproduce the reference behavior bit-for-bit.
"""

from __future__ import annotations

import dataclasses

# 2-bit base codes are A=0 C=1 G=2 T=3 N=4 (reference: src/vartype.h:20-25)
BASE_X = 7

K = 32  # k-mer length; fixed by the 64-bit packing (reference: src/vartype.h:38)

# Flag values for dictionary entries (reference: src/vartype.h:33-36)
POS_AMBIGUOUS = 0xFFFFFFFF
FLAG_UNAMBIGUOUS = 0x00
FLAG_AMBIGUOUS = 0x01

# Sentinel for "no base of this k-mer was mutated" (reference: src/qv.cc:710)
NO_MODIFICATION = 10086

GTYPE_NONE, GTYPE_REF, GTYPE_ALT, GTYPE_HET = 0, 1, 2, 3

AUX_TABLE_COLS_DEF = 10  # reference: src/vartype.h:93


@dataclasses.dataclass(frozen=True)
class GenoConfig:
    """All tunables of index build + genotyping.

    Defaults replicate the reference's compiled-in configuration
    (DEBUG=0, REF_LITE=0, PCOMPACT=0 variant).
    """

    # --- statistical model (reference: src/vartype.h:12-17, 27) ---
    read_len: int = 101
    err_rate: float = 0.01
    avg_cov: float = 7.1
    quality_score: int = ord("8")  # neighbor search iff qual[i] < this
    max_cov: int = 63  # saturating 6-bit pileup counters

    # --- dictionary structure (reference: src/vartype.h:93,103) ---
    aux_table_cols: int = 10
    block_size_threshold: int = 100

    # --- Bloom filter geometry (reference: src/generate_bf.h:201-209) ---
    ref_bf_bytes: int = 1_200_000_000
    ref_lite_bf_bytes: int = 2_300_000_000
    snp_bf_bytes: int = 140_000_000

    # --- engine shapes (new; no reference equivalent: the reference is
    # single-threaded and processes one read at a time, src/qv.cc:760) ---
    batch_reads: int = 4096        # reads per device batch
    max_read_len: int = 128        # padded read length (>= read_len)
    max_kmers_per_read: int = 4    # K slots = ceil(max_read_len/32)
    events_per_read: int = 96      # compacted hit-context capacity per read
    candidates_per_read: int = 32  # distinct candidate positions in the vote table
    neighbor_item_frac: float = 0.0625  # cap on low-qual kmers per batch, xB*K
    probe_hit_cap: int = 32        # neighbor-probe hit lanes: the compacted
                                   # hit buffer holds NH = NI * cap // 8
                                   # lanes (cap/8 average hits per low-qual
                                   # item; default 32 -> 4 hits/item), NOT a
                                   # per-item cap -- see engine.batch NH and
                                   # utils.roofline lane accounting
    agree_cap: int = 4             # AVG agreeing contexts per read: the
                                   # pileup stage's flat batch-wide context
                                   # buffer holds batch_reads*agree_cap
    sites_per_context: int = 4     # SNP sites extracted per 32-base pileup
                                   # context (set-bit extraction slots); a
                                   # window with more sites overflows the
                                   # counter and auto-escalates (max 32 =
                                   # the reference's full window)
    replicate_stride_bug: bool = True  # qv.cc:359/448 pointer-arith bug
    scan_slot_cap: int = 24        # gathered block-scan slots (<=100); real
                                   # jumpgate blocks are tiny, overflow is
                                   # counted if one exceeds the cap
    scan_active_frac: float = 0.25  # block-scan lane compaction: fraction
                                   # of the (items x scan slots) grid kept
                                   # as real test lanes (j < block size;
                                   # typical blocks are 1-2 rows against
                                   # 13-24 slots); overflow is counted and
                                   # auto-escalated with the scan caps
    sparse_events_frac: float = 0.0625  # compacted snp-exact + neighbor
                                   # event lanes kept, as a fraction of
                                   # B*(E+1) (these event classes are a
                                   # few % dense; the dense (B,K)+(NH,10)
                                   # scatters they replace were the step's
                                   # largest scatter-lane cost); overflow
                                   # counted + auto-escalated
    amb_hits_per_read: float = 0.25  # ambiguous exact hits (k-mers with
                                   # 2-10 genome positions, read through
                                   # aux rows) kept per read of a batch:
                                   # NA = B * this slots, their aux events
                                   # 4 * NA; overflow counted
                                   # (amb_overflow) + auto-escalated
    probe_active_frac: float = 0.25  # active-lane fraction kept by the
                                   # neighbor-probe pre-compaction (BF
                                   # bounds + base masks kill most lanes;
                                   # the direct bucket lookup runs on the
                                   # compacted lanes); overflow counted +
                                   # auto-escalated
    auto_tune: bool = False        # shrink lane capacities to measured
                                   # per-batch maxima x tune_headroom after
                                   # tune_batches batches (engine.autotune;
                                   # the CLI enables this by default).
                                   # Results can never change: overflow
                                   # escalation re-runs any batch whose
                                   # tuned cap trips
    tune_batches: int = 4          # batches observed before tuning
    tune_headroom: float = 2.0     # capacity = measured max x this
    auto_retry_max: int = 3        # overflow escalation rounds per batch:
                                   # a batch that trips any capacity counter
                                   # is re-run with the tripped caps doubled
                                   # (0 disables; results then may diverge
                                   # from the reference on overflow)
    pre_encode: bool = True        # host-side kmer packing in queued mode:
                                   # dispatch ships (hi, lo) u32 words +
                                   # masks (~1.3 MB/32K batch) instead of
                                   # (B, L) u8 codes (~4.2 MB) -- matters on
                                   # tunneled/high-latency dispatch links
    pipeline_depth: int = 2        # in-flight device batches in the host
                                   # dispatch loop (1 = classic double
                                   # buffering; deeper hides dispatch-link
                                   # latency at the cost of delayed retry
                                   # queueing -- results are identical)
    group_size: int = 1            # sub-batches scanned per device dispatch
                                   # (queued + pre_encode mode): one host
                                   # round trip / stats sync per GROUP --
                                   # the lever for high-latency (tunneled)
                                   # dispatch links; results are identical
    ht_target_load: float = 0.24   # combined exact-lookup table bucket load
                                   # factor (engine.device_index): 0.24
                                   # makes the probe chain 1 on most
                                   # indexes (the exact lookup is the
                                   # step's largest gather; one full
                                   # bucket anywhere forces a second row
                                   # gather for EVERY query lane); 0.5
                                   # halves the table bytes at chain 2 --
                                   # use it when HBM is the constraint

    # --- distribution ---
    route_factor: float = 2.2     # sharded-dict mode: per-(src,dst) lane
                                  # capacity as a multiple of the uniform
                                  # share (genomic hi bits are near-uniform;
                                  # overflow is counted and auto-escalated)
    route_scan_slots: int = 16    # sharded-dict mode: compacted block-scan
                                  # hits returned per routed query

    @property
    def ref_bf_bits(self) -> int:
        return self.ref_bf_bytes * 8

    @property
    def snp_bf_bits(self) -> int:
        return self.snp_bf_bytes * 8

    @property
    def ref_lite_bf_bits(self) -> int:
        return self.ref_lite_bf_bytes * 8


DEFAULT_CONFIG = GenoConfig()
