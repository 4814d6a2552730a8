"""The port's whole-genome host paths on the CPU, at a small size, against
the JAX package exactly:

- the bucketed ``build_ref_dict`` (``vargeno_tpu_torch/index/dictgen.py``)
  at 1, 2 and 16 buckets equals the JAX ``build_ref_dict`` in all four
  arrays and ``max_pos``, on the mini FASTA and on synthetic genomes with
  repeats, with runs of N, and with several chromosomes; the SNP
  dictionary and the SNP Bloom filter, which read each SNP's window of
  bases, equal the JAX builds on the same genomes;
- the ``.vgt/`` directory the port's ``build_index`` writes (bucketed)
  equals the JAX ``build_index``'s arrays;
- the streamed placement (``dist/sharded_dict.py`` ``partition_index`` +
  ``place_shards``) from an index loaded through mmap gives the JAX
  ``partition_index``'s shards, owned and total rows and plan at D = 1, 2
  and 3, and holds a few chunks of host memory (tracemalloc), not the
  dictionaries' width;
- every position moved to both sides of 2**31: the runner and the D = 2
  sharded dictionary count as on the unmoved index."""

import dataclasses
import os
import tracemalloc

import numpy as np
import pytest
import torch
from torch_index_share import (FIX, STRADDLE_2_31, jax_view,
                               shift_positions, small_index)

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.dist import sharded_dict as j_sd
from vargeno_tpu.index import bloom as j_bloom
from vargeno_tpu.index import build as j_build
from vargeno_tpu.index import dictgen as j_dictgen
from vargeno_tpu.io import fasta as j_fasta
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.dist import sharded_dict as sd
from vargeno_tpu_torch.dist.sharding import make_mesh
from vargeno_tpu_torch.engine import device_index as tdi
from vargeno_tpu_torch.engine import search
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.index import bloom, dictgen, store
from vargeno_tpu_torch.index.build import build_index
from vargeno_tpu_torch.io import fasta as fasta_io

torch.set_num_threads(2)

ACGT = np.frombuffer(b"ACGT", np.uint8)
SMALL = dict(ref_bf_bytes=1 << 21, ref_lite_bf_bytes=8,
             snp_bf_bytes=1 << 17)


def _write_fasta(path, chroms):
    with open(path, "wb") as f:
        for name, seq in chroms:
            f.write(b">" + name + b"\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60] + b"\n")


def _write_vcf(path, rows):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.0\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for j, (chrom, pos1, ref, alt) in enumerate(rows):
            f.write(f"{chrom}\t{pos1}\trs{j}\t{ref}\t{alt}\t.\t.\t"
                    f"RS={j};CAF=0.9,0.1\n")


def _snps(rng, chroms, n):
    """n VCF rows a chromosome at random positions whose base is ACGT
    (REF as the genome has it, upper-cased; ALT another base)."""
    rows = []
    for name, seq in chroms:
        if len(seq) < 100:
            continue
        raw = np.frombuffer(seq.upper(), np.uint8)
        ok = np.flatnonzero(np.isin(raw, ACGT))
        for p in np.sort(rng.choice(ok, min(n, ok.size), replace=False)):
            ref = chr(raw[p])
            alt = "ACGT"[("ACGT".index(ref) + int(rng.integers(1, 4))) % 4]
            rows.append((name.decode(), int(p) + 1, ref, alt))
    return rows


def _genome(kind: str, d: str):
    """(fasta, vcf) of one test genome in directory ``d``."""
    if kind == "mini":
        return (os.path.join(FIX, "genome.fa"),
                os.path.join(FIX, "snps.vcf"))
    rng = np.random.default_rng({"repeats": 1, "n_runs": 2,
                                 "chroms": 3}[kind])

    def rand(n):
        return ACGT[rng.integers(0, 4, n)].tobytes()

    if kind == "repeats":
        # segments copied 12 times (> 10 positions: POS_AMBIGUOUS), 3 and
        # 2 times (aux rows), a poly-A run, spread over the key space so
        # that several buckets hold ambiguous rows
        g = bytearray(rand(150_000))
        for copies, length in ((12, 60), (3, 80), (2, 45), (2, 33),
                               (5, 40), (10, 50), (11, 36)):
            seg = rand(length)
            for p in rng.integers(0, len(g) - length, copies):
                g[p:p + length] = seg
        g[70_000:70_200] = b"A" * 200
        chroms = [(b"chr1", bytes(g))]
    elif kind == "n_runs":
        g = bytearray(rand(120_000))
        for p, n in ((0, 40), (5_000, 3), (9_000, 31), (20_000, 32),
                     (40_000, 1), (60_000, 500), (119_970, 30)):
            g[p:p + n] = b"N" * n
        g[80_000:80_300] = g[80_000:80_300].lower()
        g[90_000:90_010] = b"RYKMSWRYKM"   # dict parser: N
        chroms = [(b"chr1", bytes(g))]
    else:
        chroms = [(b"chr1 first", rand(50_000)), (b"chr2", rand(20)),
                  (b"chr3", rand(31)), (b"chr4", rand(32)),
                  (b"chrX|x", rand(80_000)), (b"chr5", rand(33))]
    fa, vcf = os.path.join(d, kind + ".fa"), os.path.join(d, kind + ".vcf")
    _write_fasta(fa, chroms)
    # no SNP on IUPAC letters (the Bloom parser would refuse the genome)
    _write_vcf(vcf, _snps(rng, [(n.split()[0].split(b"|")[0], s)
                                for n, s in chroms], 400))
    return fa, vcf


GENOMES = ["mini", "repeats", "n_runs", "chroms"]


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("genomes"))
    return {k: _genome(k, d) for k in GENOMES}


@pytest.fixture(scope="module")
def jax_ref(genomes):
    return {k: j_dictgen.build_ref_dict(j_fasta.parse_fasta(fa))
            for k, (fa, _) in genomes.items()}


def _force_buckets(monkeypatch, seqs, buckets):
    """Set the bucket target so that ``build_ref_dict`` of ``seqs`` runs in
    ``buckets`` buckets."""
    rows = sum(s.size - 31 for s in seqs if s.size >= 32)
    monkeypatch.setattr(dictgen, "REF_BUCKET_BYTES", -(-rows * 12 // buckets))
    assert dictgen.ref_buckets(rows) == buckets


@pytest.mark.parametrize("buckets", [1, 2, 16])
@pytest.mark.parametrize("kind", GENOMES)
def test_bucketed_ref_dict_matches_jax(genomes, jax_ref, kind, buckets,
                                       monkeypatch):
    seqs = fasta_io.parse_fasta(genomes[kind][0])
    _force_buckets(monkeypatch, seqs, buckets)
    got, max_pos = dictgen.build_ref_dict(seqs)
    want, want_max = jax_ref[kind]
    assert max_pos == want_max
    for f in ("kmers", "pos", "flag", "aux"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if kind == "repeats":   # both kinds of ambiguous rows were built
        assert got.aux.shape[0] > 0
        assert (got.pos == 0xFFFFFFFF).any()


def test_ref_dict_bucket_counts():
    """The count follows the row count (one bucket below ~89M rows, 64 at
    the whole genome's 3G) and is a power of two up to 2**16."""
    assert dictgen.ref_buckets(0) == 1
    assert dictgen.ref_buckets(48_000_000) == 1
    assert dictgen.ref_buckets(89_000_000) == 1
    assert dictgen.ref_buckets(90_000_000) == 2
    assert dictgen.ref_buckets(300_000_000) == 4
    assert dictgen.ref_buckets(3_000_000_000) == 64
    assert dictgen.ref_buckets(10 ** 13) == 1 << 16
    for rows in (1, 10 ** 6, 123_456_789, 10 ** 10):
        nb = dictgen.ref_buckets(rows)
        assert nb & (nb - 1) == 0


@pytest.mark.parametrize("kind", GENOMES)
def test_snp_dict_and_snp_bloom_match_jax(genomes, kind):
    fa, vcf = genomes[kind]
    seqs, jseqs = fasta_io.parse_fasta(fa), j_fasta.parse_fasta(fa)
    got, locs = dictgen.build_snp_dict_from_vcf(seqs, vcf)
    want, jlocs = j_dictgen.build_snp_dict_from_vcf(jseqs, vcf)
    assert got.kmers.size > 0
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(locs, jlocs)
    np.testing.assert_array_equal(
        bloom.build_snp_bf(seqs, vcf, 1 << 20).words,
        j_bloom.build_snp_bf(jseqs, vcf, 1 << 20).words)


@pytest.mark.parametrize("kind", ["mini", "repeats"])
def test_index_dir_matches_jax_build_index(genomes, kind, tmp_path,
                                           monkeypatch):
    """The port's ``build_index`` (its ref dictionary forced through 8
    buckets by a small bucket target) writes a ``.vgt/`` whose arrays, read
    back through mmap, equal the JAX ``build_index``'s."""
    fa, vcf = genomes[kind]
    _force_buckets(monkeypatch, fasta_io.parse_fasta(fa), 8)
    prefix = str(tmp_path / "idx")
    build_index(fa, vcf, prefix, GenoConfig(**SMALL))
    got = store.load(prefix)
    want = j_build.build_index(fa, vcf, str(tmp_path / "jax"),
                               JConfig(**SMALL), write_native=False)
    pairs = dict(ref=(got.ref, want.ref), snp=(got.snp, want.snp),
                 site=(got.sites, want.sites))
    for name, (a, b) in pairs.items():
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert isinstance(x, np.memmap), (name, f.name)
            assert x.dtype == y.dtype, (name, f.name)
            np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f.name}")
    for f in ("ref_bf", "snp_bf"):
        assert getattr(got, f).bits == getattr(want, f).bits
        np.testing.assert_array_equal(getattr(got, f).words,
                                      getattr(want, f).words)
    np.testing.assert_array_equal(got.snp_locations, want.snp_locations)
    assert got.chrlens == want.chrlens


@pytest.fixture(scope="module")
def mmap_index(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("idx") / "mini")
    store.save(prefix, small_index())
    return store.load(prefix)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_streamed_placement_matches_jax(mmap_index, D, monkeypatch):
    """Placed a few hundred rows at a time from the mmap'd index, each
    host shard's key and meta tensors (pad rows included), its owned and
    total rows, and the plan equal the JAX ``partition_index``."""
    assert isinstance(mmap_index.ref.kmers, np.memmap)
    monkeypatch.setattr(sd, "PLACE_ROWS", 777)
    part = sd.partition_index(mmap_index, D)
    shards = sd.place_shards(part, make_mesh(devices=["cpu"] * D))
    _, jst, jplan, jowned, jtotals = j_sd.partition_index(
        jax_view(mmap_index), D)
    np.testing.assert_array_equal(part.plan.ref_bounds_hi,
                                  np.asarray(jplan.ref_bounds_hi))
    np.testing.assert_array_equal(part.plan.snp_bounds_hi24,
                                  np.asarray(jplan.snp_bounds_hi24))
    for k in ("ref", "snp"):
        np.testing.assert_array_equal(part.owned[k], jowned[k])
        np.testing.assert_array_equal(part.totals[k], jtotals[k])
    for d, sh in enumerate(shards):
        np.testing.assert_array_equal(
            sh.ref_key.numpy(),
            search.np_okey(jst["ref_hi"][d], jst["ref_lo"][d]))
        np.testing.assert_array_equal(
            sh.snp_key.numpy(),
            search.np_okey(jst["snp_hi"][d], jst["snp_lo"][d]))
        np.testing.assert_array_equal(sh.dix.ref_meta.numpy().view(
            np.uint32), jst["ref_meta"][d])
        np.testing.assert_array_equal(sh.dix.snp_meta.numpy().view(
            np.uint32), jst["snp_meta"][d])
        assert (sh.ref_owned, sh.snp_owned, sh.ref_total, sh.snp_total) \
            == (jowned["ref"][d], jowned["snp"][d], jtotals["ref"][d],
                jtotals["snp"][d])
        assert sh.dix.n_ref_rows == jst["ref_hi"].shape[1]


def test_read_rows_of_a_memory_map(mmap_index):
    """``read_rows`` of a memory-mapped column reads the file: the same
    rows as slicing, past the end cut, 2-D rows whole, and an array that is
    no whole-file map sliced as it is."""
    k, aux = mmap_index.ref.kmers, mmap_index.snp.aux_pos
    n = k.shape[0]
    for s, e in ((0, 10), (n - 5, n + 100), (7, 7), (1000, 1500)):
        got = store.read_rows(k, s, e)
        assert not isinstance(got, np.memmap)
        np.testing.assert_array_equal(got, k[s:e])
    np.testing.assert_array_equal(store.read_rows(aux, 2, 9), aux[2:9])
    np.testing.assert_array_equal(store.read_rows(k[10:], 0, 5), k[10:15])


def _synthetic_index(rng, n_ref, n_snp, n_sites, genome):
    """A VarGenoIndex of random sorted rows (no genome behind it)."""
    from vargeno_tpu_torch.index.bloom import BitVector

    def keys(n):
        return np.unique(rng.integers(0, 2 ** 64 - 1, n, dtype=np.uint64))

    rk, sk = keys(n_ref), keys(n_snp)
    zeros = np.zeros
    ref = dictgen.RefDict(
        kmers=rk, pos=rng.integers(1, genome, rk.size, dtype=np.uint32),
        flag=zeros(rk.size, np.uint8), aux=zeros((0, 10), np.uint32))
    snp = dictgen.SnpDict(
        kmers=sk, pos=rng.integers(1, genome, sk.size, dtype=np.uint32),
        snp=rng.integers(0, 256, sk.size, dtype=np.uint8),
        flag=zeros(sk.size, np.uint8), ref_freq=zeros(sk.size, np.uint8),
        alt_freq=zeros(sk.size, np.uint8), aux_kmer=zeros(0, np.uint64),
        aux_pos=zeros((0, 10), np.uint32), aux_snp=zeros((0, 10), np.uint8),
        aux_rf=zeros((0, 10), np.uint8), aux_af=zeros((0, 10), np.uint8))
    sp = np.unique(rng.integers(1, genome, n_sites, dtype=np.uint32))
    sites = store.SnpSites(pos=sp, ref=zeros(sp.size, np.uint8),
                           alt=np.ones(sp.size, np.uint8),
                           rf=zeros(sp.size, np.uint8),
                           af=zeros(sp.size, np.uint8))
    return store.VarGenoIndex(
        ref=ref, snp=snp, ref_bf=BitVector.zeros(1 << 12),
        snp_bf=BitVector.zeros(1 << 12), chrlens=[("chr1", genome)],
        sites=sites)


def test_streamed_placement_holds_a_few_chunks(tmp_path, monkeypatch):
    """Planning and placing 4,000,000 ref and 500,000 SNP rows (72 MB of
    shards) from the mmap'd index at D = 2 allocate no more host memory
    than a few chunks of 65,536 rows (1 MB of keys and meta) beside the
    replicated tables: numpy reports its allocations to tracemalloc, the
    shard tensors are torch's."""
    rng = np.random.default_rng(5)
    store.save(str(tmp_path / "syn"),
               _synthetic_index(rng, 4_000_000, 500_000, 20_000, 1 << 22))
    index = store.load(str(tmp_path / "syn"))
    monkeypatch.setattr(sd, "PLACE_ROWS", 1 << 16)
    monkeypatch.setattr(tdi, "SCAN_ROWS", 1 << 16)
    chunk = (1 << 16) * 16
    mesh = make_mesh(devices=["cpu", "cpu"])
    tracemalloc.start()
    try:
        part = sd.partition_index(index, 2)
        plan_peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        shards = sd.place_shards(part, mesh)
        place_peak = tracemalloc.get_traced_memory()[1] - before
    finally:
        tracemalloc.stop()
    replicated = sum(part.fields[f].nbytes for f in sd.REPLICATED)
    assert sum(s.ref_key.numel() for s in shards) >= 4_000_000
    # (72 MB of shards; a full-width plan that stacks the shards on the
    # host first peaks at ~173 MB of numpy arrays on this index)
    assert plan_peak < 2 * chunk + 2 * replicated, (plan_peak, chunk)
    assert place_peak < 3 * chunk + replicated, (place_peak, chunk)


@pytest.mark.parametrize("runner", ["GenoRunner", "sharded D = 2"])
def test_positions_straddling_2_31(runner):
    """Every position of the mini index (ref, SNP, aux rows, sites) moved
    by one constant to both sides of 2**31: per-site counts equal those
    of the unmoved index through the same runner."""
    base = small_index()
    moved = shift_positions(base, STRADDLE_2_31)
    assert moved.sites.pos.min() < (1 << 31) <= moved.sites.pos.max()
    assert (moved.ref.pos[moved.ref.flag == 0] >= (1 << 31)).any()
    cfg = GenoConfig(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
    fq = os.path.join(FIX, "reads.fq")

    def counts(index):
        if runner == "GenoRunner":
            run = GenoRunner(index, cfg, device="cpu")
        else:
            run = sd.ShardedDictGenoRunner(
                index, make_mesh(devices=["cpu", "cpu"]), cfg)
        run.consume_fastq(fq)
        assert not {k: v for k, v in run.stats_totals.items()
                    if "overflow" in k and v}
        return run.host_counts()

    want = counts(base)
    assert int(want[0].sum() + want[1].sum()) > 0
    got = counts(moved)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
