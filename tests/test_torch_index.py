"""The port's index build against the reference binary's goldens, and the
port's device-table derivation against the JAX package's
``build_device_index(host_only=True)`` carried through ``from_numpy``."""

import os

import numpy as np
import pytest
import torch
from torch_index_share import jax_view, small_index

from vargeno_tpu.engine.device_index import build_device_index as j_build
from vargeno_tpu_torch.engine import device_index as tdi
from vargeno_tpu_torch.engine.hashtable import ht_lookup_both
from vargeno_tpu_torch.index import bloom, dictgen, store
from vargeno_tpu_torch.io import fasta as fasta_io

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "mini")


@pytest.fixture(scope="module")
def seqs():
    return fasta_io.parse_fasta(os.path.join(FIX, "genome.fa"))


def test_ref_dict_matches_golden(seqs):
    golden = store.read_ref_dict(os.path.join(FIX, "golden.ref.dict"))
    ours, _ = dictgen.build_ref_dict(seqs)
    for f in ("kmers", "pos", "flag", "aux"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(golden, f))


def test_snp_dict_matches_golden(seqs):
    golden = store.read_snp_dict(os.path.join(FIX, "golden.snp.dict"))
    ours, locs = dictgen.build_snp_dict_from_vcf(
        seqs, os.path.join(FIX, "snps.vcf"))
    for f in ("kmers", "pos", "snp", "flag", "ref_freq", "alt_freq",
              "aux_kmer", "aux_pos", "aux_snp", "aux_rf", "aux_af"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(golden, f))
    assert locs.any()


def _set_bits(bv):
    nz = np.flatnonzero(bv.words)
    bits = np.unpackbits(bv.words[nz].view(np.uint8),
                         bitorder="little").reshape(len(nz), 64)
    rows, cols = np.nonzero(bits)
    return np.sort(nz[rows].astype(np.uint64) * np.uint64(64)
                   + cols.astype(np.uint64))


@pytest.mark.parametrize("which", ["ref", "snp"])
def test_bloom_matches_golden(seqs, which):
    if which == "ref":
        g = np.load(os.path.join(FIX, "golden_ref_bf.npz"))
        lite_g = np.load(os.path.join(FIX, "golden_ref_bf_lite_bf.npz"))
        ref_bf, lite_bf = bloom.build_ref_bfs(seqs, int(g["bits"]),
                                              int(lite_g["bits"]))
        np.testing.assert_array_equal(_set_bits(ref_bf), g["set_bits"])
        np.testing.assert_array_equal(_set_bits(lite_bf),
                                      lite_g["set_bits"])
    else:
        g = np.load(os.path.join(FIX, "golden_snp_bf.npz"))
        bf = bloom.build_snp_bf(seqs, os.path.join(FIX, "snps.vcf"),
                                int(g["bits"]))
        np.testing.assert_array_equal(_set_bits(bf), g["set_bits"])


def test_from_numpy_of_jax_tables_matches_port_derivation():
    port_index = small_index()
    jd = j_build(jax_view(port_index), host_only=True, ht_target_load=0.5)
    fields = {f: getattr(jd, f) for f in tdi.DEVICE_FIELDS}
    statics = {f: getattr(jd, f) for f in tdi.STATIC_FIELDS}
    from_jax = tdi.from_numpy(fields, statics, "cpu")
    ours = tdi.build_device_index(port_index, "cpu", ht_target_load=0.5)

    for f in tdi.STATIC_FIELDS + ("n_sites",):
        assert getattr(from_jax, f) == getattr(ours, f), f
    for f in tdi.DEVICE_FIELDS:
        if f == "both_ht":
            continue
        a, b = getattr(from_jax, f), getattr(ours, f)
        assert a.dtype == b.dtype == torch.int32, f
        assert torch.equal(a, b), f
    assert ours.ref_hi.shape[1] == 32

    # the combined tables may place keys differently: compare lookups
    keys = np.concatenate([port_index.ref.kmers, port_index.snp.kmers,
                           port_index.ref.kmers ^ np.uint64(1)])
    hi = torch.from_numpy((keys >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.int64))
    got = [ht_lookup_both(d.both_ht, d.both_ht_nb, d.both_ht_chain, hi, lo)
           for d in (from_jax, ours)]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    assert bool(got[1][0][:port_index.ref.kmers.size].all())
