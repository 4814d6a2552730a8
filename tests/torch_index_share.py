"""Indexes for the port's tests that keep a worker's memory small (tier-1
runs six workers in one machine's memory).

``jax_view``: the JAX package's dataclasses over a port index's arrays
(no copy), so the JAX runners and oracle run on ``small_index()``.

``small_index``: the mini fixture's index at a small Bloom geometry, built
by the port's own (jax-free) index code: no 1.2 GB filter at all. A ref
Bloom filter of 2**24 bits can change which neighbor probes are pruned; on
this fixture the geno output still equals the golden VCF, which the runner
tests built on it assert."""

import dataclasses
import os

from vargeno_tpu_torch.index import bloom, dictgen, store
from vargeno_tpu_torch.io import fasta as fasta_io

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "mini")


def _shared(obj, cls):
    """``cls`` over the same field values as the dataclass ``obj``."""
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls)})


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


def shift_positions(index: store.VarGenoIndex, c: int):
    """``index`` with ``c`` added to every genome position it holds: the
    unambiguous ref and SNP rows' positions, the aux rows' (their zero
    padding stays zero) and the sites'. Aux row numbers and POS_AMBIGUOUS
    stay. Reads count the same sites in it."""
    import numpy as np

    from vargeno_tpu_torch.config import FLAG_UNAMBIGUOUS

    c = np.uint32(c)

    def at(pos, flag):
        return np.where(flag == FLAG_UNAMBIGUOUS, pos + c, pos).astype(
            np.uint32)

    def aux(a):
        return np.where(a != 0, a + c, 0).astype(np.uint32)

    r, s = index.ref, index.snp
    return dataclasses.replace(
        index, prefix=None,
        ref=dataclasses.replace(r, pos=at(r.pos, r.flag), aux=aux(r.aux)),
        snp=dataclasses.replace(s, pos=at(s.pos, s.flag),
                                aux_pos=aux(s.aux_pos)),
        sites=dataclasses.replace(index.sites,
                                  pos=(index.sites.pos + c).astype(
                                      np.uint32)))


# a shift that puts the mini index's positions (1 .. ~140,000) on both
# sides of 2**31
STRADDLE_2_31 = (1 << 31) - 70_000


def head_fastq(src: str, dst: str, n: int) -> str:
    """The first ``n`` records of the FASTQ ``src``, written to ``dst``."""
    with open(src) as f:
        lines = f.readlines()[:4 * n]
    with open(dst, "w") as f:
        f.writelines(lines)
    return dst


# a tiny bench workload (``vargeno_tpu_torch.tools.bench`` knobs)
BENCH_KNOBS = dict(VGT_BENCH_MB="0.2", VGT_BENCH_SNPS="2000",
                   VGT_BENCH_READS="4096", VGT_BENCH_BATCH="512",
                   VGT_BENCH_PASSES="3", VGT_BENCH_MAX_EXTRA="2")


def bench_cache(cache: str) -> dict:
    """The tiny bench workload's dataset and index in ``cache``, the index
    at a small Bloom geometry (built through the bench's own
    ``build_index``, so its ``ibuild.json`` is there too). Returns the
    environment that points the bench tools at it."""
    from vargeno_tpu_torch.config import GenoConfig
    from vargeno_tpu_torch.tools import bench

    k = BENCH_KNOBS
    wl = bench.Workload(cache=cache, mb=float(k["VGT_BENCH_MB"]),
                        snps=int(k["VGT_BENCH_SNPS"]),
                        reads=int(k["VGT_BENCH_READS"]),
                        batch=int(k["VGT_BENCH_BATCH"]),
                        passes=int(k["VGT_BENCH_PASSES"]))
    bench.build_dataset(wl)
    bench.build_index(wl, GenoConfig(ref_bf_bytes=1 << 21,
                                     ref_lite_bf_bytes=1 << 21,
                                     snp_bf_bytes=1 << 18))
    return dict(BENCH_KNOBS, VGT_BENCH_CACHE=cache)
