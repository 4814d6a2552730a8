"""Indexes for the port's tests that keep a worker's memory small (tier-1
runs six workers in one machine's memory).

``port_view``: the port's view of the JAX package's shared test index
(tests/conftest.py mini_index): the port's dataclasses over the same numpy
arrays, with no copy, so a test worker holds one 1.2 GB Bloom filter and
not two.

``jax_view``: the inverse, the JAX package's dataclasses over a port
index's arrays (no copy), so the JAX runners and oracle run on
``small_index()``.

``small_index``: the mini fixture's index at a small Bloom geometry, built
by the port's own (jax-free) index code: no 1.2 GB filter at all. A ref
Bloom filter of 2**24 bits can change which neighbor probes are pruned; on
this fixture the geno output still equals the golden VCF, which the runner
tests built on it assert."""

import dataclasses
import os

from vargeno_tpu_torch.index import bloom, dictgen, store
from vargeno_tpu_torch.index.bloom import BitVector
from vargeno_tpu_torch.index.dictgen import RefDict, SnpDict
from vargeno_tpu_torch.io import fasta as fasta_io

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "mini")


def _shared(obj, cls):
    """``cls`` over the same field values as the dataclass ``obj``."""
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})


def port_view(j) -> store.VarGenoIndex:
    return store.VarGenoIndex(
        ref=_shared(j.ref, RefDict), snp=_shared(j.snp, SnpDict),
        ref_bf=_shared(j.ref_bf, BitVector),
        snp_bf=_shared(j.snp_bf, BitVector), chrlens=j.chrlens,
        sites=_shared(j.sites, store.SnpSites),
        snp_locations=j.snp_locations)


def jax_view(p):
    """The JAX package's VarGenoIndex over the port index ``p``'s arrays
    (imported here: the GPU tests import this module without jax)."""
    from vargeno_tpu.index import bloom as j_bloom
    from vargeno_tpu.index import dictgen as j_dictgen
    from vargeno_tpu.index import store as j_store

    return j_store.VarGenoIndex(
        ref=_shared(p.ref, j_dictgen.RefDict),
        snp=_shared(p.snp, j_dictgen.SnpDict),
        ref_bf=_shared(p.ref_bf, j_bloom.BitVector),
        snp_bf=_shared(p.snp_bf, j_bloom.BitVector), chrlens=p.chrlens,
        sites=_shared(p.sites, j_store.SnpSites),
        snp_locations=p.snp_locations)


def small_index() -> store.VarGenoIndex:
    seqs = fasta_io.parse_fasta(os.path.join(FIX, "genome.fa"))
    vcf = os.path.join(FIX, "snps.vcf")
    ref_bf, _ = bloom.build_ref_bfs(seqs, 1 << 24, 64)
    snp_dict, locs = dictgen.build_snp_dict_from_vcf(seqs, vcf)
    ref_dict, _ = dictgen.build_ref_dict(seqs)
    return store.VarGenoIndex(
        ref=ref_dict, snp=snp_dict, ref_bf=ref_bf,
        snp_bf=bloom.build_snp_bf(seqs, vcf, 1 << 20),
        chrlens=[(s.name, s.size) for s in seqs],
        sites=store.derive_sites(snp_dict), snp_locations=locs)


def head_fastq(src: str, dst: str, n: int) -> str:
    """The first ``n`` records of the FASTQ ``src``, written to ``dst``."""
    with open(src) as f:
        lines = f.readlines()[:4 * n]
    with open(dst, "w") as f:
        f.writelines(lines)
    return dst
