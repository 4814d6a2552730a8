"""The genome-scale tools' repeat-rich draw (``rehearse_wgs --dup-share``)
on the CPU at 1 Mb / 5,000 SNPs / 2,048 reads, 30 % of the genome in
segment families (``testing.plant_families``, the law of
``testing.synth_repeat_genome``):

- ``synth_repeat_genome`` draws the same genomes as before its planting
  loop became ``plant_families`` (digests of the draws of the 48 Mb phase's
  seed and of ``test_torch_ambiguous``'s, at 300 kb), and leaves its
  generator in the same state;
- the draw keeps the uniform draw's SNP positions and writes a ready marker
  of its own; making a draw removes the other draws' markers;
- the port's index of it reaches aux rows and POS_AMBIGUOUS rows, and its
  ``.vgt/`` arrays equal the JAX ``build_index``'s on the same FASTA and VCF;
- through the port's GenoRunner and the D = 2 sharded dictionary at B =
  512, where the ambiguous-exact capacity spills and escalates, the counts
  equal the JAX package's sequential oracle's at every site."""

import argparse
import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch
from torch_index_share import jax_view

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.index import build as j_build
from vargeno_tpu.oracle import OracleEngine as JOracle
from vargeno_tpu_torch.config import (FLAG_AMBIGUOUS, POS_AMBIGUOUS,
                                      GenoConfig)
from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.index.build import build_index
from vargeno_tpu_torch.testing import synth_repeat_genome
from vargeno_tpu_torch.tools import endurance_wgs, rehearse_wgs

torch.set_num_threads(2)

MB, SNPS, READS, BATCH, DUP_SHARE = 1, 5000, 2048, 512, 0.3
SMALL = dict(ref_bf_bytes=1 << 21, ref_lite_bf_bytes=8, snp_bf_bytes=1 << 17)


@pytest.fixture(scope="module")
def draw(tmp_path_factory):
    """The repeat-rich 1 Mb draw and the port's small-Bloom index of it."""
    d = str(tmp_path_factory.mktemp("wgs_repeats"))
    fa, vcf, fq = rehearse_wgs.gen_inputs(d, MB, SNPS, READS,
                                          dup_share=DUP_SHARE)
    prefix = os.path.join(d, "wgs")
    build_index(fa, vcf, prefix, GenoConfig(**SMALL))
    return dict(cache=d, fa=fa, vcf=vcf, fq=fq, index=store.load(prefix))


@pytest.mark.parametrize("seed, dup_share, digest, after", [
    (20261017, 0.3,
     "c4827857acb464bb3eb2b4fa0d46cf1e9a3ce0da291f640806c8ad0048b7d819",
     1041677439),
    (3, 0.15,
     "cc6b4d471cff757bc4bf8abc02b55dc32644977be536eaff1490d0f5c94f1c62",
     491386500)])
def test_synth_repeat_genome_draws_as_before(seed, dup_share, digest, after):
    rng = np.random.default_rng(seed)
    (name, bases), = synth_repeat_genome(rng, 300_000, dup_share)
    assert name == "chrR1"
    assert hashlib.sha256("".join(bases).encode()).hexdigest() == digest
    assert rng.integers(0, 1 << 30) == after


def _vcf_pos(path):
    with open(path) as f:
        return [line.split("\t")[1] for line in f if not line.startswith("#")]


def test_draw_keeps_snp_positions_and_a_marker_of_its_own(draw, tmp_path):
    d = str(tmp_path)
    fa, vcf, _ = rehearse_wgs.gen_inputs(d, MB, SNPS, READS)
    plain = rehearse_wgs.ready_marker(d, MB, SNPS, READS)
    dup = rehearse_wgs.ready_marker(d, MB, SNPS, READS, DUP_SHARE)
    assert plain != dup and os.path.exists(plain) and not os.path.exists(dup)
    assert os.path.exists(os.path.join(draw["cache"],
                                       os.path.basename(dup)))
    assert _vcf_pos(vcf) == _vcf_pos(draw["vcf"])
    with open(fa, "rb") as f, open(draw["fa"], "rb") as g:
        a, b = f.read(), g.read()
    assert len(a) == len(b) and a != b
    rehearse_wgs.gen_inputs(d, MB, SNPS, READS, dup_share=DUP_SHARE)
    assert os.path.exists(dup) and not os.path.exists(plain)
    with open(fa, "rb") as f:
        assert f.read() == b


def test_endurance_legs_take_the_dup_share():
    args = argparse.Namespace(
        cache="c", mb=MB, snps=SNPS, base_reads=READS, dup_share=DUP_SHARE,
        device="cpu", batch=BATCH, reads=4096, checkpoint_every=2,
        progress_every=0.0, devices=None)
    cmd = endurance_wgs.leg_command(args, [])
    assert cmd[cmd.index("--dup-share") + 1] == str(DUP_SHARE)


def test_index_reaches_aux_and_unusable_rows(draw):
    ref, snp = draw["index"].ref, draw["index"].snp
    aux = (ref.flag == FLAG_AMBIGUOUS) & (ref.pos != POS_AMBIGUOUS)
    assert aux.sum() > 10_000 and ref.aux.shape[0] >= aux.sum()
    assert (ref.pos == POS_AMBIGUOUS).sum() > 100
    assert snp.aux_pos.shape[0] > 0


def test_index_dir_matches_jax_build_index(draw, tmp_path):
    got = draw["index"]
    want = j_build.build_index(draw["fa"], draw["vcf"], str(tmp_path / "jax"),
                               JConfig(**SMALL), write_native=False)
    for name, (a, b) in dict(ref=(got.ref, want.ref), snp=(got.snp, want.snp),
                             site=(got.sites, want.sites)).items():
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype, (name, f.name)
            np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f.name}")
    for f in ("ref_bf", "snp_bf"):
        np.testing.assert_array_equal(getattr(got, f).words,
                                      getattr(want, f).words)


@pytest.fixture(scope="module")
def jax_oracle(draw):
    """The JAX package's sequential oracle's (ref, alt) counts at every
    site over the draw's reads."""
    index = draw["index"]
    oracle = JOracle(jax_view(index))
    oracle.run_fastq(draw["fq"])
    pos = index.sites.pos
    return oracle.config.max_cov, tuple(
        np.array([oracle.pileup[int(p)][col] for p in pos]) for col in (4, 5))


@pytest.mark.parametrize("runner, devices", [("ht", None),
                                             ("sharded", ["cpu", "cpu"])])
def test_counts_equal_the_jax_oracle(draw, jax_oracle, runner, devices):
    mc, want = jax_oracle
    r = rehearse_wgs.make_runner(draw["index"], rehearse_wgs.geno_config(BATCH),
                                 runner, "cpu", devices)
    got = rehearse_wgs.stream(r, draw["fq"], progress_every=0)
    assert got["reads"] == READS
    assert sum(v for k, v in got["first_attempt"].items()
               if k.endswith("amb_overflow")) > 0
    assert got["escalations"] > 0
    assert not {k: v for k, v in got["stats"].items()
                if "overflow" in k and v}
    n = want[0].shape[0]
    assert want[0].sum() + want[1].sum() > 0
    for g, w in zip(r.host_counts(), want):
        np.testing.assert_array_equal(np.minimum(g[:n], mc), w)
