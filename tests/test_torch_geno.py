"""End to end on the CPU: the port's GenoRunner and CLI on the mini fixture
must write a VCF byte-identical to the reference binary's golden output,
with per-site counts equal to the JAX GenoRunner's, at default capacities
and at tiny ones that only overflow escalation can recover from. The index
is the port's own small-Bloom one (``torch_index_share.small_index``), the
JAX runner's the same arrays through ``jax_view``."""

import os

import numpy as np
import pytest
import torch
from torch_index_share import jax_view, small_index

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.engine.geno import GenoRunner as JRunner
from vargeno_tpu_torch import cli
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.engine.geno import GenoRunner, _escalate_config
from vargeno_tpu_torch.index import store

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "mini")
GOLDEN = open(os.path.join(FIX, "golden_output.vcf")).read()
BASE = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
TINY = dict(events_per_read=6, candidates_per_read=4, probe_hit_cap=4,
            agree_cap=2, scan_slot_cap=4, sites_per_context=1,
            sparse_events_frac=0.001, neighbor_item_frac=0.004,
            auto_retry_max=6)


@pytest.fixture(scope="module")
def port_index():
    return small_index()


def _run(index, cfg, tmp_path):
    runner = GenoRunner(index, cfg, device="cpu")
    runner.consume_fastq(os.path.join(FIX, "reads.fq"))
    out = str(tmp_path / "out.vcf")
    runner.write_vcf(os.path.join(FIX, "snps.vcf"), out)
    return runner, open(out).read()


def test_geno_matches_golden_and_jax_counts(port_index, tmp_path):
    runner, vcf = _run(port_index, GenoConfig(**BASE), tmp_path)
    assert vcf == GOLDEN
    assert all(v == 0 for k, v in runner.stats_totals.items()
               if "overflow" in k), runner.stats_totals
    jrun = JRunner(jax_view(port_index), JConfig(**BASE))
    jrun.consume_fastq(os.path.join(FIX, "reads.fq"))
    rc, ac = runner.host_counts()
    np.testing.assert_array_equal(rc, np.asarray(jrun.ref_cnt))
    np.testing.assert_array_equal(ac, np.asarray(jrun.alt_cnt))
    assert runner.n_reads == jrun.n_reads
    assert runner.n_retry_reads == jrun.n_retry_reads
    assert (runner.stats_totals["n_processed"]
            == jrun.stats_totals["n_processed"])


def test_tiny_caps_escalate_to_golden(port_index, tmp_path):
    cfg = GenoConfig(**BASE, **TINY)
    runner, vcf = _run(port_index, cfg, tmp_path)
    assert runner._cfg_run != cfg and runner.n_escalations > 0
    assert all(v == 0 for k, v in runner.stats_totals.items()
               if "overflow" in k), runner.stats_totals
    assert vcf == GOLDEN


def test_escalate_config_doubles_tripped_caps():
    cfg = GenoConfig(**TINY)
    up = _escalate_config(cfg, ["event_overflow", "cand_overflow",
                                "probe_overflow", "agree_overflow",
                                "snp_scan_overflow", "ni_overflow",
                                "act_overflow", "sev_overflow",
                                "site_slot_overflow"])
    assert (up.events_per_read, up.candidates_per_read) == (12, 8)
    assert (up.probe_hit_cap, up.agree_cap, up.scan_slot_cap) == (8, 4, 8)
    assert up.neighbor_item_frac == 0.008
    assert up.sites_per_context == 2
    assert up.scan_active_frac == min(2 * cfg.scan_active_frac, 1.0)
    assert up.probe_active_frac == min(2 * cfg.probe_active_frac, 1.0)
    assert up.sparse_events_frac == 0.002
    assert up.batch_reads == cfg.batch_reads
    assert _escalate_config(cfg, []) is cfg


def test_cli_geno_cpu_matches_golden(port_index, tmp_path):
    prefix = str(tmp_path / "idx")
    store.save(prefix, port_index)   # the CLI reads it back, mmapped
    out = str(tmp_path / "cli.vcf")
    rc = cli.main(["geno", prefix, os.path.join(FIX, "reads.fq"),
                   os.path.join(FIX, "snps.vcf"), out, "--device", "cpu",
                   "--batch-reads", "512"])
    assert rc == 0
    assert open(out).read() == GOLDEN


def test_cli_geno_refuses_missing_gpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = cli.main(["geno", str(tmp_path / "idx"),
                   os.path.join(FIX, "reads.fq"),
                   os.path.join(FIX, "snps.vcf"), str(tmp_path / "x.vcf")])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.vcf").exists()
