"""Jax-free port of ``vargeno_tpu/index/build.py``, no longer a pure copy:
it frees what the rest of the build does not need (the lite Bloom filter
unless the reference's files are written, the sequences once both
dictionaries are built), and its index must equal the JAX ``build_index``'s
array for array (tests/test_torch_wgs_stream.py).

`vargeno index`-equivalent orchestration (reference: src/qv.cc:2239-2389).

Builds, from a FASTA + VCF:
  - ref/snp Bloom filters (BF-style raw parse, src/qv.cc:2328-2332),
  - the .chrlens sidecar (dict-style names, src/qv.cc:2336-2348),
  - the SNP dictionary then the reference dictionary (src/qv.cc:2350-2374),
and persists either the native .vgt.npz or the reference's binary formats.
"""

from __future__ import annotations

import time

from ..io import fasta as fasta_io
from . import bloom, dictgen, store
from ..config import GenoConfig, DEFAULT_CONFIG


def build_index(ref_fasta: str, snp_vcf: str, prefix: str,
                config: GenoConfig = DEFAULT_CONFIG,
                write_reference_format: bool = False,
                write_native: bool = True,
                timings: dict | None = None) -> store.VarGenoIndex:
    """Build (and write) the index; ``timings``, when given, receives each
    stage's seconds."""
    t = [time.perf_counter()]

    def lap(stage):
        now = time.perf_counter()
        if timings is not None:
            timings[stage] = now - t[0]
        t[0] = now

    seqs = fasta_io.parse_fasta(ref_fasta)
    lap("parse")

    ref_bf, lite_bf = bloom.build_ref_bfs(
        seqs, config.ref_bf_bits, config.ref_lite_bf_bits)
    if not write_reference_format:
        lite_bf = None   # written nowhere else
    lap("ref_bloom")
    snp_bf = bloom.build_snp_bf(seqs, snp_vcf, config.snp_bf_bits)
    lap("snp_bloom")

    with open(prefix + ".chrlens", "w") as f:
        f.write(fasta_io.chrlens_text(seqs))
    chrlens = [(s.name, s.size) for s in seqs]

    snp_dict, snp_locs = dictgen.build_snp_dict_from_vcf(
        seqs, snp_vcf, config.aux_table_cols)
    lap("snp_dict")
    ref_dict, _max_pos = dictgen.build_ref_dict(seqs, config.aux_table_cols)
    del seqs   # the genome's bytes: nothing below reads them
    lap("ref_dict")

    index = store.VarGenoIndex(
        ref=ref_dict, snp=snp_dict, ref_bf=ref_bf, snp_bf=snp_bf,
        chrlens=chrlens, sites=store.derive_sites(snp_dict),
        snp_locations=snp_locs)
    lap("sites")

    if write_native:
        store.save(prefix, index)
    if write_reference_format:
        store.write_ref_dict(prefix + ".ref.dict", ref_dict)
        store.write_snp_dict(prefix + ".snp.dict", snp_dict)
        store.write_sdsl_bf(prefix + ".ref.bf", ref_bf)
        store.write_sdsl_bf(prefix + ".ref.bf.lite.bf", lite_bf)
        store.write_sdsl_bf(prefix + ".snp.bf", snp_bf)
    lap("write")
    return index
