"""The single-GPU runner's modes on the CPU: the non-queued dual loop,
auto-tune, checkpoint / resume, cohort and their CLI flags. Every run's VCF
must be byte-identical to the reference binary's ``golden_output.vcf``;
``tuned_config`` is held against the JAX one on the same telemetry; a
checkpoint written by either package is resumed by the other.

All runs share one mini index at a small Bloom geometry (no 1.2 GB filter
in this file); on this fixture its output still equals the golden VCF."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch
from torch_index_share import FIX, small_index

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.engine import checkpoint as j_ckpt
from vargeno_tpu.engine.autotune import tuned_config as j_tuned_config
from vargeno_tpu.engine.geno import GenoRunner as JRunner
from vargeno_tpu_torch import cli
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.engine import checkpoint as ckpt
from vargeno_tpu_torch.engine.autotune import TUNE_KEYS, tuned_config
from vargeno_tpu_torch.engine.cohort import CohortRunner
from vargeno_tpu_torch.engine.device_index import build_device_index
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.index import store

torch.set_num_threads(2)

FQ = os.path.join(FIX, "reads.fq")
VCF = os.path.join(FIX, "snps.vcf")
GOLDEN = open(os.path.join(FIX, "golden_output.vcf")).read()
BASE = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
TINY = dict(events_per_read=6, candidates_per_read=4, probe_hit_cap=4,
            agree_cap=2, scan_slot_cap=4, sites_per_context=1,
            sparse_events_frac=0.001, neighbor_item_frac=0.004,
            auto_retry_max=6)


@pytest.fixture(scope="module")
def shared():
    index = small_index()
    return index, build_device_index(index, "cpu",
                                     GenoConfig().ht_target_load)


def _runner(shared, cfg, **kw):
    index, dix = shared
    return GenoRunner(index, cfg, device="cpu", dix=dix, **kw)


def _vcf(runner, tmp_path):
    out = str(tmp_path / "out.vcf")
    runner.write_vcf(VCF, out)
    return open(out).read()


def _no_overflow(runner):
    return all(v == 0 for k, v in runner.stats_totals.items()
               if "overflow" in k)


def test_non_queued_matches_golden(shared, tmp_path):
    runner = _runner(shared, GenoConfig(**BASE), queued_orientation=False)
    runner.consume_fastq(FQ)
    assert _vcf(runner, tmp_path) == GOLDEN
    assert _no_overflow(runner), runner.stats_totals
    assert runner.n_reads == 20443 and runner.n_retry_reads == 0
    assert "fwd_ev_max" in runner.stats_totals   # the dual step ran
    assert runner.meter.reads == runner.n_reads
    assert runner.meter.batches == 40


def test_non_queued_tiny_caps_escalate_to_golden(shared, tmp_path):
    """A dual batch reports its overflow under fwd_/rev_ keys; escalation
    must strip the prefix or the run would never recover."""
    cfg = GenoConfig(**BASE, **TINY)
    runner = _runner(shared, cfg, queued_orientation=False)
    tripped = set()
    bump = runner._bump
    runner._bump = lambda st: (tripped.update(st), bump(st))
    runner.consume_fastq(FQ)
    assert "fwd_event_overflow" in tripped
    assert runner.n_escalations > 0
    assert runner._cfg_run.events_per_read > cfg.events_per_read
    assert _no_overflow(runner), runner.stats_totals
    assert _vcf(runner, tmp_path) == GOLDEN


def test_auto_tune_fires_and_matches_golden(shared, tmp_path):
    cfg = GenoConfig(**BASE, auto_tune=True, tune_batches=3)
    runner = _runner(shared, cfg)
    runner.consume_fastq(FQ)
    assert runner._tuned and runner._tune_seen == 3
    assert runner._cfg_run.events_per_read < cfg.events_per_read
    assert runner._cfg_run.batch_reads == cfg.batch_reads
    # a tuned capacity tripped later, and escalation redid those batches
    assert runner.n_escalations > 0
    assert _no_overflow(runner), runner.stats_totals
    assert _vcf(runner, tmp_path) == GOLDEN
    # without the flag nothing is tuned
    assert _runner(shared, GenoConfig(**BASE))._tuned


def test_auto_tune_in_dual_mode_reads_prefixed_telemetry(shared, tmp_path):
    cfg = GenoConfig(**BASE, auto_tune=True, tune_batches=2)
    runner = _runner(shared, cfg, queued_orientation=False)
    runner.consume_fastq(FQ, limit_batches=6)
    assert set(runner._tune_max) == set(TUNE_KEYS)
    assert runner._cfg_run.events_per_read < cfg.events_per_read
    assert _no_overflow(runner), runner.stats_totals


_TELEMETRY = {
    "typical": dict(ev_max=7, lowq_n=80, probe_lanes_max=100,
                    act_lanes_max=500, ref_scan_lanes_max=90,
                    snp_scan_lanes_max=120, agree_lanes_max=700),
    "nothing_shrinks": dict(ev_max=100, lowq_n=10**6,
                            probe_lanes_max=10**6, act_lanes_max=10**7,
                            ref_scan_lanes_max=10**6,
                            snp_scan_lanes_max=10**6,
                            agree_lanes_max=10**6),
    "partial": dict(ev_max=3, act_lanes_max=65),
    "empty": {},
}


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("name", sorted(_TELEMETRY))
def test_tuned_config_matches_jax(name, big):
    dix = types.SimpleNamespace(ref_scan_max=150 if big else 4,
                                snp_scan_max=6)
    kw = dict(batch_reads=1024, max_kmers_per_read=4)
    got = tuned_config(GenoConfig(**kw), dix, _TELEMETRY[name], 2.0)
    want = j_tuned_config(JConfig(**kw), dix, _TELEMETRY[name], 2.0)
    for f in dataclasses.fields(GenoConfig):
        if not hasattr(want, f.name):   # the port's own capacity: untuned
            assert f.name == "amb_hits_per_read"
            assert getattr(got, f.name) == getattr(GenoConfig(**kw), f.name)
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    if name in ("nothing_shrinks", "empty"):
        assert got == GenoConfig(**kw)
    else:
        assert got != GenoConfig(**kw)


def test_checkpoint_resume_matches_golden(shared, tmp_path):
    path = str(tmp_path / "ck")
    cfg = GenoConfig(**BASE)
    first = _runner(shared, cfg)
    first.consume_fastq(FQ, limit_batches=8, checkpoint_path=path,
                        checkpoint_every=4)
    assert 0 < first.n_reads < 20443
    rc, ac, meta = ckpt.load(path)
    assert meta["n_reads"] == first.n_reads
    np.testing.assert_array_equal(rc, first.host_counts()[0])
    # the queue was drained before the save: a fresh run over just those
    # reads, retries included, counts the same
    assert int(rc.sum() + ac.sum()) > 0
    second = _runner(shared, cfg)
    second.consume_fastq(FQ, checkpoint_path=path)
    assert second.n_reads == 20443
    assert _vcf(second, tmp_path) == GOLDEN
    # a third runner finds the finished checkpoint and has nothing to add
    third = _runner(shared, cfg)
    third.consume_fastq(FQ, checkpoint_path=path)
    assert _vcf(third, tmp_path) == GOLDEN


def test_checkpoint_resume_non_queued(shared, tmp_path):
    path = str(tmp_path / "ck")
    cfg = GenoConfig(**BASE)
    first = _runner(shared, cfg, queued_orientation=False)
    first.consume_fastq(FQ, limit_batches=5, checkpoint_path=path,
                        checkpoint_every=2)
    assert first.n_reads == 5 * 512
    second = _runner(shared, cfg, queued_orientation=False)
    second.consume_fastq(FQ, checkpoint_path=path)
    assert _vcf(second, tmp_path) == GOLDEN


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(shared, tmp_path, writer):
    """State carried across: a checkpoint written by one package's runner
    is resumed by the other's, and the finished VCF is the golden one."""
    index, _ = shared
    path = str(tmp_path / "ck")
    out = str(tmp_path / "out.vcf")
    if writer == "jax":
        first = JRunner(index, JConfig(**BASE))
        first.consume_fastq(FQ, limit_batches=8, checkpoint_path=path,
                            checkpoint_every=4)
        assert 0 < first.n_reads < 20443
        second = _runner(shared, GenoConfig(**BASE))
    else:
        first = _runner(shared, GenoConfig(**BASE))
        first.consume_fastq(FQ, limit_batches=8, checkpoint_path=path,
                            checkpoint_every=4)
        assert j_ckpt.load(path)[2]["n_reads"] == first.n_reads
        second = JRunner(index, JConfig(**BASE))
    second.consume_fastq(FQ, checkpoint_path=path)
    assert second.n_reads == 20443
    second.write_vcf(VCF, out)
    assert open(out).read() == GOLDEN


def test_cohort_matches_golden(shared, tmp_path):
    index, _ = shared
    cohort = CohortRunner(index, ["full", "part", "none"],
                          GenoConfig(**BASE), device="cpu")
    cohort.consume_sample("full", FQ)
    cohort.consume_sample("part", FQ, limit_batches=2)
    outs = cohort.write_vcfs(VCF, str(tmp_path / "c_{sample}.vcf"))
    assert [os.path.basename(o) for o in outs] == [
        "c_full.vcf", "c_part.vcf", "c_none.vcf"]
    full, part, none = (open(o).read() for o in outs)
    assert full == GOLDEN
    assert part != GOLDEN and none != part
    assert cohort.stats["full"]["n_processed"] \
        > cohort.stats["part"]["n_processed"] > 0
    assert cohort.stats["none"] == {}


@pytest.fixture(scope="module")
def saved_prefix(shared, tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("idx") / "mini")
    store.save(prefix, shared[0])
    return prefix


def test_cli_geno_modes(saved_prefix, tmp_path):
    out = str(tmp_path / "cli.vcf")
    ck = str(tmp_path / "ck")
    metrics = str(tmp_path / "m.jsonl")
    common = ["geno", saved_prefix, FQ, VCF, out, "--device", "cpu",
              "--batch-reads", "512", "--checkpoint", ck]
    # auto-tune is on by default in the CLI; stop early, then resume inline
    assert cli.main(common + ["--limit-batches", "6"]) == 0
    assert open(out).read() != GOLDEN
    assert cli.main(common + ["--inline-dual", "--no-auto-tune",
                              "--metrics", metrics]) == 0
    assert open(out).read() == GOLDEN
    snap = json.loads(open(metrics).read())
    assert snap["reads"] > 0 and snap["batches"] > 0


def test_cli_cohort_and_help(saved_prefix, tmp_path, capsys):
    pattern = str(tmp_path / "s_{sample}.vcf")
    rc = cli.main(["cohort", saved_prefix, VCF, pattern, f"a={FQ}",
                   "--device", "cpu", "--batch-reads", "512"])
    assert rc == 0
    assert open(pattern.format(sample="a")).read() == GOLDEN
    assert cli.main(["cohort", saved_prefix, VCF, pattern, "no-equals",
                     "--device", "cpu"]) == 1
    assert cli.main(["help"]) == 0
    text = capsys.readouterr().out
    for cmd in ("index", "geno", "cohort", "filt", "ucscd", "ucscbf",
                "encodebf", "vcfd", "vcfbf"):
        assert cmd in text


def test_cli_cohort_refuses_missing_gpu(saved_prefix, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pattern = str(tmp_path / "s_{sample}.vcf")
    assert cli.main(["cohort", saved_prefix, VCF, pattern, f"a={FQ}"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(pattern.format(sample="a"))
