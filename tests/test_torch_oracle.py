"""The port's sequential oracle (``oracle.py``, the executable specification
of ``geno``) against the JAX package's on the same reads of the mini
fixture, exactly; ``oracle-geno`` and ``kmerc`` against the JAX CLI's
output; and the D = 2 routed runner against the port's oracle, site by
site. All on the small index."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_index_share import FIX, head_fastq, jax_view, small_index

from vargeno_tpu import cli as j_cli
from vargeno_tpu.oracle import OracleEngine as JOracle
from vargeno_tpu_torch import cli
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
from vargeno_tpu_torch.dist.sharding import make_mesh
from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.oracle import OracleEngine

torch.set_num_threads(2)

FQ = os.path.join(FIX, "reads.fq")
VCF = os.path.join(FIX, "snps.vcf")
N_READS = 2000


@pytest.fixture(scope="module")
def index():
    return small_index()


@pytest.fixture(scope="module")
def oracle(index):
    eng = OracleEngine(index)
    eng.run_fastq(FQ, limit=N_READS)
    return eng


def test_oracle_matches_jax(index, oracle):
    j = JOracle(jax_view(index))
    j.run_fastq(FQ, limit=N_READS)
    assert oracle.pileup == j.pileup
    assert sum(e[4] + e[5] for e in oracle.pileup.values()) > 0
    pos, vals = oracle.counts()
    j_pos, j_vals = j.counts()
    np.testing.assert_array_equal(pos, j_pos)
    np.testing.assert_array_equal(vals, j_vals)


def test_parallel_oracle_equals_sequential(oracle):
    """The fork-parallel run, in a fresh process (forking this one, with its
    JAX and torch threads, could deadlock a child) with a time limit."""
    code = (
        "import json, sys; sys.path.insert(0, 'tests'); "
        "from torch_index_share import FIX, small_index; "
        "from vargeno_tpu_torch.oracle import OracleEngine; "
        "e = OracleEngine(small_index()); "
        f"e.run_fastq_parallel(FIX + '/reads.fq', workers=2, "
        f"limit={N_READS}); "
        "json.dump(sorted((p, v[4], v[5]) for p, v in e.pileup.items()), "
        "sys.stdout)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = [tuple(x) for x in json.loads(r.stdout)]
    assert got == sorted((p, v[4], v[5]) for p, v in oracle.pileup.items())


def test_oracle_geno_and_kmerc_match_jax_cli(index, tmp_path, capsys,
                                             monkeypatch):
    monkeypatch.setenv("VGT_COMPILE_CACHE", "0")
    prefix = str(tmp_path / "idx")
    store.save(prefix, index)
    fq = head_fastq(FQ, str(tmp_path / "head.fq"), N_READS)
    outs = []
    for main, tag in ((cli.main, "port"), (j_cli.main, "jax")):
        out = str(tmp_path / f"{tag}.vcf")
        assert main(["oracle-geno", prefix, fq, VCF, out]) == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1]
    assert "GT" in outs[0]
    texts = []
    for main in (cli.main, j_cli.main):
        capsys.readouterr()
        assert main(["kmerc", os.path.join(FIX, "genome.fa")]) == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]
    assert "distinct LO32: " in texts[0] and "distinct LO40: " in texts[0]


def test_routed_d2_matches_oracle(index, oracle, tmp_path):
    fq = head_fastq(FQ, str(tmp_path / "head.fq"), N_READS)
    cfg = GenoConfig(batch_reads=256, max_read_len=128, max_kmers_per_read=4)
    runner = ShardedDictGenoRunner(index, make_mesh(devices=["cpu"] * 2),
                                   cfg)
    runner.consume_fastq(fq)
    assert not {k: v for k, v in runner.stats_totals.items()
                if "overflow" in k and v}
    rc, ac = runner.host_counts()
    s = index.sites
    n = s.pos.shape[0]
    want_r = np.array([oracle.pileup[int(p)][4] for p in s.pos])
    want_a = np.array([oracle.pileup[int(p)][5] for p in s.pos])
    np.testing.assert_array_equal(np.minimum(rc[:n], cfg.max_cov), want_r)
    np.testing.assert_array_equal(np.minimum(ac[:n], cfg.max_cov), want_a)
    assert want_r.sum() + want_a.sum() > 0
