"""Index variants of the port against the reference binary's golden files:
the ``filt`` dictionary (``golden.filt.ref.dict``) and the geno run on it
(``golden_filt_output.vcf``), the UCSC SNP-txt dictionary and Bloom filter
(``golden.ucsc.snp.dict``, ``golden_ucsc_snp_bf.npz``), the encode-file
Bloom filter, and their CLI subcommands. Each port function is also held
against its JAX-package original on the same input. Everything is bytes or
integers: exact equality."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch_index_share import FIX, small_index

from vargeno_tpu.index import filt as j_filt
from vargeno_tpu.index import ucsc as j_ucsc
from vargeno_tpu.io import fasta as j_fasta
from vargeno_tpu_torch import cli
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.core.hashes import np_hash40
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.index import filt, store, ucsc
from vargeno_tpu_torch.io import fasta as fasta_io

torch.set_num_threads(2)

UCSC = os.path.join(FIX, "snps.ucsc")
VCF = os.path.join(FIX, "snps.vcf")


@pytest.fixture(scope="module")
def index():
    return small_index()


@pytest.fixture(scope="module")
def seqs():
    return fasta_io.parse_fasta(os.path.join(FIX, "genome.fa"))


def _set_bits(bv):
    nz = np.flatnonzero(bv.words)
    bits = np.unpackbits(bv.words[nz].view(np.uint8),
                         bitorder="little").reshape(len(nz), 64)
    r, c = np.nonzero(bits)
    return np.sort(nz[r].astype(np.uint64) * np.uint64(64)
                   + c.astype(np.uint64))


def _filtered(index):
    """The filtered index as a new object with no prefix: its derived
    tables must not land in the unfiltered index's disk cache."""
    ref = filt.filt_ref_dict(index.ref, index.snp_locations)
    return dataclasses.replace(index, ref=ref, prefix=None)


def test_filt_dict_bit_identical(index, tmp_path):
    new = _filtered(index)
    assert 0 < new.ref.kmers.shape[0] < index.ref.kmers.shape[0]
    out = str(tmp_path / "filt.ref.dict")
    store.write_ref_dict(out, new.ref)
    assert open(out, "rb").read() == open(
        os.path.join(FIX, "golden.filt.ref.dict"), "rb").read()
    want = j_filt.filt_ref_dict(index.ref, index.snp_locations)
    for f in ("kmers", "pos", "flag", "aux"):
        np.testing.assert_array_equal(getattr(new.ref, f), getattr(want, f))


def test_geno_after_filt_matches_reference(index, tmp_path):
    cfg = GenoConfig(batch_reads=512, max_read_len=128,
                     max_kmers_per_read=4)
    runner = GenoRunner(_filtered(index), cfg, device="cpu")
    runner.consume_fastq(os.path.join(FIX, "reads.fq"))
    out = str(tmp_path / "filt_output.vcf")
    runner.write_vcf(VCF, out)
    assert open(out).read() == open(
        os.path.join(FIX, "golden_filt_output.vcf")).read()


def test_cli_filt_writes_its_own_prefix(index, tmp_path, capsys):
    prefix, out_prefix = str(tmp_path / "full"), str(tmp_path / "filt")
    store.save(prefix, index)
    assert cli.main(["filt", prefix, out_prefix]) == 0
    assert "New size:" in capsys.readouterr().out
    back = store.load(out_prefix)
    assert back.prefix == out_prefix
    np.testing.assert_array_equal(back.ref.kmers, _filtered(index).ref.kmers)
    # the unfiltered index on disk is untouched
    np.testing.assert_array_equal(store.load(prefix).ref.kmers,
                                  index.ref.kmers)
    assert not os.path.exists(os.path.join(prefix + ".vgt", "derived_torch"))


def test_ucsc_snp_dict_parity(seqs):
    golden = store.read_snp_dict(os.path.join(FIX, "golden.ucsc.snp.dict"))
    ours, locs = ucsc.build_snp_dict_ucsc(seqs, UCSC)
    theirs, j_locs = j_ucsc.build_snp_dict_ucsc(
        j_fasta.parse_fasta(os.path.join(FIX, "genome.fa")), UCSC)
    for f in ("kmers", "pos", "snp", "flag", "ref_freq", "alt_freq",
              "aux_pos"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(golden, f))
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    np.testing.assert_array_equal(locs, j_locs)
    assert locs.any()


def test_ucsc_snp_bf_parity(seqs):
    g = np.load(os.path.join(FIX, "golden_ucsc_snp_bf.npz"))
    bf = ucsc.build_snp_bf_ucsc(seqs, UCSC, int(g["bits"]))
    np.testing.assert_array_equal(_set_bits(bf), g["set_bits"])


def test_encode_bf(tmp_path):
    path = str(tmp_path / "vals.enc")
    with open(path, "w") as f:
        f.write("12345 x\n0x1f\n999999999999\n")
    bf = ucsc.build_snp_bf_encode(path, 1 << 20)
    want = np_hash40(np.array([12345, 0x1F, 999999999999],
                              np.uint64)) % np.uint64(1 << 20)
    np.testing.assert_array_equal(_set_bits(bf), np.unique(want))
    np.testing.assert_array_equal(
        bf.words, j_ucsc.build_snp_bf_encode(path, 1 << 20).words)


def test_cli_ucscd_and_vcfd_write_golden_dicts(tmp_path):
    fa = str(tmp_path / "genome.fa")   # the chrlens file lands beside it
    with open(os.path.join(FIX, "genome.fa"), "rb") as f, \
            open(fa, "wb") as g:
        g.write(f.read())

    def same(a, b):
        return open(a, "rb").read() == open(os.path.join(FIX, b),
                                            "rb").read()

    ref, snp = str(tmp_path / "u.ref.dict"), str(tmp_path / "u.snp.dict")
    assert cli.main(["ucscd", fa, UCSC, ref, snp]) == 0
    assert same(snp, "golden.ucsc.snp.dict")
    assert same(ref, "golden.ref.dict")
    assert same(fa + ".chrlens", "golden.chrlens")
    ref, snp = str(tmp_path / "v.ref.dict"), str(tmp_path / "v.snp.dict")
    assert cli.main(["vcfd", fa, VCF, ref, snp]) == 0
    assert same(snp, "golden.snp.dict")
    assert same(ref, "golden.ref.dict")
