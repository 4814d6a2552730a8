"""Jax-free copy of ``vargeno_tpu/index/build.py``.

`vargeno index`-equivalent orchestration (reference: src/qv.cc:2239-2389).

Builds, from a FASTA + VCF:
  - ref/snp Bloom filters (BF-style raw parse, src/qv.cc:2328-2332),
  - the .chrlens sidecar (dict-style names, src/qv.cc:2336-2348),
  - the SNP dictionary then the reference dictionary (src/qv.cc:2350-2374),
and persists either the native .vgt.npz or the reference's binary formats.
"""

from __future__ import annotations

from ..io import fasta as fasta_io
from . import bloom, dictgen, store
from ..config import GenoConfig, DEFAULT_CONFIG


def build_index(ref_fasta: str, snp_vcf: str, prefix: str,
                config: GenoConfig = DEFAULT_CONFIG,
                write_reference_format: bool = False,
                write_native: bool = True) -> store.VarGenoIndex:
    seqs = fasta_io.parse_fasta(ref_fasta)

    ref_bf, lite_bf = bloom.build_ref_bfs(
        seqs, config.ref_bf_bits, config.ref_lite_bf_bits)
    snp_bf = bloom.build_snp_bf(seqs, snp_vcf, config.snp_bf_bits)

    with open(prefix + ".chrlens", "w") as f:
        f.write(fasta_io.chrlens_text(seqs))

    snp_dict, snp_locs = dictgen.build_snp_dict_from_vcf(
        seqs, snp_vcf, config.aux_table_cols)
    ref_dict, _max_pos = dictgen.build_ref_dict(seqs, config.aux_table_cols)

    index = store.VarGenoIndex(
        ref=ref_dict, snp=snp_dict, ref_bf=ref_bf, snp_bf=snp_bf,
        chrlens=[(s.name, s.size) for s in seqs],
        sites=store.derive_sites(snp_dict),
        snp_locations=snp_locs)

    if write_native:
        store.save(prefix, index)
    if write_reference_format:
        store.write_ref_dict(prefix + ".ref.dict", ref_dict)
        store.write_snp_dict(prefix + ".snp.dict", snp_dict)
        store.write_sdsl_bf(prefix + ".ref.bf", ref_bf)
        store.write_sdsl_bf(prefix + ".ref.bf.lite.bf", lite_bf)
        store.write_sdsl_bf(prefix + ".snp.bf", snp_bf)
    return index
