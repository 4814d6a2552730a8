"""The port's streamed ``filt`` (``vargeno_tpu_torch/index/filt.py``
``filt_prefix``) on the CPU, against the JAX package exactly:

- the ``.vgt/`` it writes equals the JAX ``filt_prefix``'s file by file,
  byte for byte (every array and meta.json), on the uniform and the
  repeat-rich 1 Mb draws of ``rehearse_wgs.gen_inputs`` (the latter's
  ambiguous and POS_AMBIGUOUS rows all kept) and on a multi-chromosome
  genome with SNPs within 100 bases of both of its ends and of its
  chromosome boundaries, at chunks of 1 row, of a prime and of more rows
  than the dictionary;
- its traced host memory on a 10,000,000-row dictionary stays under one
  byte a genome base plus 64 bytes a row of a chunk (the
  in-memory ``filt_ref_dict`` takes ~70 bytes a row of the dictionary);
- geno on the index it filters, through the GenoRunner and the D = 1
  sharded dictionary, writes the VCF the JAX GenoRunner writes on the JAX
  ``filt_prefix``'s index, on a 200 kb two-chromosome draw."""

import os
import tracemalloc

import numpy as np
import pytest
import torch

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.engine.geno import GenoRunner as JRunner
from vargeno_tpu.index import filt as j_filt
from vargeno_tpu.index import store as j_store
from vargeno_tpu_torch.config import (FLAG_AMBIGUOUS, POS_AMBIGUOUS,
                                      GenoConfig)
from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
from vargeno_tpu_torch.dist.sharding import make_mesh
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.index import dictgen, filt, store
from vargeno_tpu_torch.index.bloom import BitVector
from vargeno_tpu_torch.index.build import build_index
from vargeno_tpu_torch.testing import make_synthetic
from vargeno_tpu_torch.tools import rehearse_wgs

torch.set_num_threads(2)

SMALL = dict(ref_bf_bytes=1 << 21, ref_lite_bf_bytes=8, snp_bf_bytes=1 << 17)
# 1 Mb at the whole genome's density (5,000,000 SNPs over 3 Gb)
MB, SNPS, READS = 1, 1667, 2048
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _edges_genome(d: str):
    """A FASTA of four chromosomes (the second shorter than a window) and a
    VCF whose SNPs lie on the genome's first base, within 100 bases of both
    of its ends and of every chromosome boundary, and a few inside; the
    last lies 50 bases before the end, so that k-mers start past it."""
    rng = np.random.default_rng(15)
    chroms = [(b"chr1", 2500), (b"chr2", 90), (b"chr3", 1700),
              (b"chrX", 2200)]
    seqs = [ACGT[rng.integers(0, 4, n)].tobytes() for _, n in chroms]
    fa, vcf = os.path.join(d, "edges.fa"), os.path.join(d, "edges.vcf")
    with open(fa, "wb") as f:
        for (name, _), s in zip(chroms, seqs):
            f.write(b">" + name + b"\n")
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60] + b"\n")
    at = {0: [0, 5, 68, 69, 70, 99, 1200, 2430, 2499], 1: [0, 45, 89],
          2: [3, 99, 1000, 1650], 3: [40, 1100, 2101, 2150]}
    with open(vcf, "w") as f:
        f.write("##fileformat=VCFv4.0\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        j = 0
        for c, ps in at.items():
            for p in ps:
                ref = chr(seqs[c][p])
                alt = "ACGT"[("ACGT".index(ref) + 1 + j % 3) % 4]
                f.write(f"{chroms[c][0].decode()}\t{p + 1}\trs{j}\t{ref}\t"
                        f"{alt}\t.\t.\tRS={j};CAF=0.9,0.1\n")
                j += 1
    return fa, vcf


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """Each draw's small-Bloom index on disk, by kind."""
    out = {}
    for kind, dup in (("uniform", 0.0), ("repeats", 0.3)):
        d = str(tmp_path_factory.mktemp(kind))
        fa, vcf, _ = rehearse_wgs.gen_inputs(d, MB, SNPS, READS,
                                             dup_share=dup)
        out[kind] = os.path.join(d, "wgs")
        build_index(fa, vcf, out[kind], GenoConfig(**SMALL))
    d = str(tmp_path_factory.mktemp("edges"))
    out["edges"] = os.path.join(d, "edges")
    build_index(*_edges_genome(d), out["edges"], GenoConfig(**SMALL))
    return out


@pytest.fixture(scope="module")
def jax_filtered(indexes):
    """The JAX ``filt_prefix``'s index of each draw, by kind."""
    out = {}
    for kind, prefix in indexes.items():
        out[kind] = prefix + "_jaxfilt"
        j_filt.filt_prefix(prefix, out[kind])
    return out


def _same_dirs(a: str, b: str) -> list:
    """The files of two ``.vgt/`` directories, after asserting that both
    hold the same names with the same bytes."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name
    return names


@pytest.mark.parametrize("kind, chunk", [
    ("edges", 1), ("edges", 13), ("edges", 1 << 30),
    ("uniform", 7919), ("uniform", 1 << 30),
    ("repeats", 7919), ("repeats", 1 << 30)])
def test_streamed_filt_equals_jax(indexes, jax_filtered, kind, chunk,
                                  tmp_path, capsys, monkeypatch):
    prefix, out = indexes[kind], str(tmp_path / "filt")
    monkeypatch.setattr(filt, "FILT_CHUNK", chunk)
    kept = filt.filt_prefix(prefix, out)
    assert f"New size: {kept}" in capsys.readouterr().out
    names = _same_dirs(out + ".vgt", jax_filtered[kind] + ".vgt")
    assert "meta.json" in names and len(names) == len(store._DIR_ARRAYS) + 1
    full, got = store.load(prefix), store.load(out)
    want = filt.filt_ref_dict(full.ref, full.snp_locations)
    np.testing.assert_array_equal(got.ref.kmers, want.kmers)
    assert kept == got.ref.kmers.shape[0] < full.ref.kmers.shape[0]
    if kind == "repeats":   # every ambiguous row is kept
        for mask in (lambda r: r.pos == POS_AMBIGUOUS,
                     lambda r: r.flag == FLAG_AMBIGUOUS):
            n = int(mask(full.ref).sum())
            assert n > 100 and int(mask(got.ref).sum()) == n
    if kind == "edges":   # rows start past the last SNP, none is kept
        size = full.snp_locations.shape[0]
        past = (full.ref.pos >= size) & (full.ref.pos != POS_AMBIGUOUS)
        assert size < sum(n for _, n in full.chrlens) and past.any()
        assert not ((got.ref.pos >= size)
                    & (got.ref.pos != POS_AMBIGUOUS)).any()


def test_filt_refuses_its_own_prefix(indexes):
    with pytest.raises(SystemExit):
        filt.filt_prefix(indexes["edges"], indexes["edges"])
    assert store.exists(indexes["edges"])


def test_npy_writer_moves_rows_behind_a_longer_header(tmp_path,
                                                      monkeypatch):
    """Where numpy's header grows with the row count, the rows written
    behind the first header are moved behind the final one."""
    real = filt._npy_header

    def growing(dtype, shape):
        h = real(dtype, shape)
        return h if shape[0] == 0 else h + b" " * 64

    monkeypatch.setattr(filt, "_npy_header", growing)
    monkeypatch.setattr(filt, "COPY_BYTES", 48)
    rows = np.arange(100, dtype=np.uint64).reshape(50, 2)
    path = str(tmp_path / "a.npy")
    w = filt.NpyWriter(path, rows.dtype, (2,))
    for s in range(0, 50, 7):
        w.append(rows[s:s + 7])
    w.close()
    with open(path, "rb") as f:
        assert f.read() == growing(rows.dtype, (50, 2)) + rows.tobytes()


def _synthetic_index(rng, n_ref, genome):
    """An index of n_ref random sorted ref rows over a genome of ``genome``
    bases with a SNP every 600 (no genome behind it), some rows ambiguous
    and some past the last SNP."""
    z = np.zeros
    kmers = np.unique(rng.integers(0, 2 ** 64 - 1, n_ref, dtype=np.uint64))
    n = kmers.size
    pos = rng.integers(0, genome + 1000, n, dtype=np.uint32)
    pos[::997] = POS_AMBIGUOUS
    flag = z(n, np.uint8)
    flag[::1009] = FLAG_AMBIGUOUS
    locs = z(genome, bool)
    locs[rng.choice(genome, genome // 600, replace=False)] = True
    locs[-1] = True
    snp = dictgen.SnpDict(
        kmers=kmers[:8], pos=pos[:8], snp=z(8, np.uint8), flag=z(8, np.uint8),
        ref_freq=z(8, np.uint8), alt_freq=z(8, np.uint8),
        aux_kmer=z(0, np.uint64), aux_pos=z((0, 10), np.uint32),
        aux_snp=z((0, 10), np.uint8), aux_rf=z((0, 10), np.uint8),
        aux_af=z((0, 10), np.uint8))
    sites = store.SnpSites(pos=z(1, np.uint32), ref=z(1, np.uint8),
                           alt=z(1, np.uint8), rf=z(1, np.uint8),
                           af=z(1, np.uint8))
    return store.VarGenoIndex(
        ref=dictgen.RefDict(kmers=kmers, pos=pos, flag=flag,
                            aux=z((3, 10), np.uint32)),
        snp=snp, ref_bf=BitVector.zeros(1 << 12),
        snp_bf=BitVector.zeros(1 << 12), chrlens=[("chr1", genome)],
        sites=sites, snp_locations=locs)


def test_streamed_filt_host_memory_is_bounded(tmp_path, monkeypatch):
    """Filtering 10,000,000 ref rows over a 10 Mb genome in 65,536-row
    chunks: numpy's traced allocations peak under one byte a genome base
    (the mask is an eighth of one) plus 64 bytes a row of a chunk and one
    copy buffer; the in-memory filter's peak is over ten times that."""
    genome, rows, chunk = 10_000_000, 10_000_000, 1 << 16
    monkeypatch.setattr(filt, "FILT_CHUNK", chunk)
    monkeypatch.setattr(filt, "COPY_BYTES", 1 << 20)
    prefix = str(tmp_path / "syn")
    store.save(prefix, _synthetic_index(np.random.default_rng(9), rows,
                                        genome))
    bound = genome + chunk * 64 + filt.COPY_BYTES
    tracemalloc.start()
    try:
        kept = filt.filt_prefix(prefix, str(tmp_path / "out"))
        streamed = tracemalloc.get_traced_memory()[1]
        full = store.load(prefix)
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        want = filt.filt_ref_dict(full.ref, full.snp_locations)
        in_memory = tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()
    got = store.load(str(tmp_path / "out"))
    np.testing.assert_array_equal(got.ref.kmers, want.kmers)
    np.testing.assert_array_equal(got.ref.pos, want.pos)
    np.testing.assert_array_equal(got.ref.flag, want.flag)
    assert kept == want.kmers.shape[0]
    assert streamed < bound, (streamed, bound)
    assert in_memory > 10 * bound and in_memory > 60 * rows, in_memory


def test_geno_on_the_filtered_index_equals_jax(tmp_path):
    """A 200 kb draw over two chromosomes: the VCF of the port's GenoRunner
    and of its D = 1 sharded dictionary on the streamed filt's index equal
    the JAX GenoRunner's on the JAX filt's index, and differ from the
    unfiltered index's."""
    index, _, vcf, fq = make_synthetic(
        seed=15, tmpdir=str(tmp_path), sizes=(120_000, 80_000),
        names=("chrA", "chrB"), n_snps=300, n_reads=4096)
    prefix = str(tmp_path / "full")
    store.save(prefix, index)
    filt.filt_prefix(prefix, str(tmp_path / "port"))
    j_filt.filt_prefix(prefix, str(tmp_path / "jax"))
    _same_dirs(str(tmp_path / "port.vgt"), str(tmp_path / "jax.vgt"))
    filtered = store.load(str(tmp_path / "port"))
    assert filtered.ref.kmers.shape[0] < 0.9 * index.ref.kmers.shape[0]
    cfg = GenoConfig(batch_reads=512, max_read_len=128, max_kmers_per_read=4)

    def vcf_of(runner, name):
        runner.consume_fastq(fq)
        assert not {k: v for k, v in runner.stats_totals.items()
                    if "overflow" in k and v}
        out = str(tmp_path / name)
        runner.write_vcf(vcf, out)
        with open(out, "rb") as f:
            return f.read()

    want = vcf_of(JRunner(j_store.load(str(tmp_path / "jax")),
                          JConfig(batch_reads=512, max_read_len=128,
                                  max_kmers_per_read=4)), "jax.vcf")
    assert vcf_of(GenoRunner(filtered, cfg, device="cpu"), "ht.vcf") == want
    assert vcf_of(ShardedDictGenoRunner(
        filtered, make_mesh(devices=["cpu"]), cfg), "d1.vcf") == want
    assert vcf_of(GenoRunner(store.load(prefix), cfg, device="cpu"),
                  "full.vcf") != want
