"""The ambiguous-exact-hit capacity of the port on a repeat-rich genome
(``testing.synth_repeat_genome``: a 300 kb chromosome, 15 % of it in
families of 2-10 copies with 1 % substitutions, and one 16-copy family).
Exact hits on k-mers with 2-10 genome positions are compacted into
``NA = B * amb_hits_per_read`` slots and their aux events into ``4 * NA``;
at the default 0.25 a read both spill on this input at B = 512. The spill
is reported (``amb_overflow``) and escalated like every other capacity, so
every runner's counts equal the sequential oracle's at every site, while
the JAX package, which drops the spill unreported, does not."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch
from torch_index_share import jax_view

import vargeno_tpu.engine.geno as j_geno
from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
from vargeno_tpu_torch.dist.sharding import ShardedGenoRunner
from vargeno_tpu_torch.engine.geno import GenoRunner, _escalate_config
from vargeno_tpu_torch.oracle import OracleEngine
from vargeno_tpu_torch.testing import (build_synth_index, synth_repeat_genome,
                                       write_inputs)
from vargeno_tpu_torch.tools import fuzz_diff

torch.set_num_threads(2)

B = 512
SEED, DUP_SHARE, N_SNPS, N_READS = 3, 0.15, 999, 4096


@pytest.fixture(scope="module")
def prep(tmp_path_factory):
    """The repeat-rich fixture and the port's oracle over it, as the
    fuzzer's ``Prepared`` (so ``fuzz_diff.bad_sites`` is the rule)."""
    d = str(tmp_path_factory.mktemp("repeats"))
    rng = np.random.default_rng(SEED)
    genome = synth_repeat_genome(rng, 300_000, DUP_SHARE)
    fa, vcf, fq = write_inputs(d, rng, genome, n_snps=N_SNPS,
                               n_reads=N_READS)
    index = build_synth_index(fa, vcf)
    oracle = OracleEngine(index)
    oracle.run_fastq(fq)
    case = dict(seed=SEED, synth=dict(sizes=(300_000,), n_snps=N_SNPS,
                                      n_reads=N_READS, err_frac=0.15),
                config=dict(batch_reads=B, events_per_read=96,
                            agree_cap=4), queued=True)
    return fuzz_diff.Prepared(case, index, vcf, fq,
                              *fuzz_diff.site_counts(oracle, index), 0.0)


def _recording(runner):
    """Keep the stats row of every attempt the runner settles."""
    rows = []
    settle = runner._settle

    def recorded(*a):
        out = settle(*a)
        rows.append(dict(out[0]))
        return out
    runner._settle = recorded
    return rows


def test_generator_reaches_aux_rows_and_unusable_rows(prep):
    """The genome holds k-mers of 2-10 positions (aux rows) and of more
    than 10 (POS_AMBIGUOUS), and the oracle counts reads on it."""
    from vargeno_tpu_torch.config import FLAG_AMBIGUOUS, POS_AMBIGUOUS

    ref = prep.index.ref
    amb = ref.flag == FLAG_AMBIGUOUS
    assert (amb & (ref.pos != POS_AMBIGUOUS)).sum() > 1000
    assert (ref.pos == POS_AMBIGUOUS).sum() > 100
    assert prep.orc_ref.sum() + prep.orc_alt.sum() > 0


def test_default_config_spills_then_escalates(prep):
    """At the default capacity the first attempt of the first batch
    spills; the batch is redone at a doubled ``amb_hits_per_read`` and no
    attempt that was kept has a spill left."""
    runner = GenoRunner(prep.index, GenoConfig(batch_reads=B), device="cpu")
    rows = _recording(runner)
    runner.consume_fastq(prep.fq)
    assert rows[0]["amb_overflow"] > 0
    assert rows[1]["amb_overflow"] == 0
    assert runner.stats_totals["amb_overflow"] == 0
    assert runner.stats_totals["amb_hits"] > 0
    assert runner._cfg_run.amb_hits_per_read > 0.25
    assert runner.n_escalations > 0


def test_spill_is_reported_without_retry(prep):
    """With escalation off the spill is left in the totals and the
    runner's warning names it."""
    cfg = GenoConfig(batch_reads=B, auto_retry_max=0)
    runner = GenoRunner(prep.index, cfg, device="cpu")
    with pytest.warns(UserWarning, match="amb_overflow"):
        runner.consume_fastq(prep.fq)
    assert runner.stats_totals["amb_overflow"] > 0
    assert runner.n_escalations == 0


RUNNERS = {
    "queued": (fuzz_diff.geno_runner, True),
    "inline-dual": (fuzz_diff.geno_runner, False),
    "mesh-D2": (fuzz_diff.mesh_runner(ShardedGenoRunner, 2), True),
    "sharded-dict-D1": (fuzz_diff.mesh_runner(ShardedDictGenoRunner, 1),
                        True),
    "sharded-dict-D2": (fuzz_diff.mesh_runner(ShardedDictGenoRunner, 2),
                        True),
}


@pytest.mark.parametrize("name", list(RUNNERS))
def test_runner_equals_oracle_after_escalation(prep, name):
    make, queued = RUNNERS[name]
    case = dict(prep.case, queued=queued)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # no overflow may be left
        got = fuzz_diff.check(dataclasses.replace(prep, case=case), "cpu",
                              make, say=lambda m: None)
    assert got["mismatches"] == 0 and not got["overflow"], got
    assert got["escalations"] > 0 and got["reads"] == N_READS


def test_jax_runner_differs_from_oracle(prep):
    """A fault of the JAX package, shown: its step drops the spill of the
    ambiguous-exact compaction without a counter, so on this input its
    counts differ from the oracle's (the port's equal them, above)."""
    j = j_geno.GenoRunner(jax_view(prep.index), JConfig(batch_reads=B))
    j.consume_fastq(prep.fq)
    bad = fuzz_diff.bad_sites(prep, np.asarray(j.ref_cnt),
                              np.asarray(j.alt_cnt))
    assert "amb_overflow" not in j.stats_totals
    assert bad, ("expected the JAX package's fault to show here "
                 "(vargeno_tpu/engine/batch.py drops the spilled ambiguous "
                 "exact hits and aux events unreported), but its counts "
                 "equal the oracle's: this input no longer spills")


def test_escalation_doubles_amb_hits_per_read_to_its_cap():
    cfg = GenoConfig(max_kmers_per_read=3)
    seen = [cfg.amb_hits_per_read]
    for key in ["amb_overflow", "fwd_amb_overflow", "rev_amb_overflow",
                "amb_overflow", "amb_overflow", "amb_overflow"]:
        cfg = _escalate_config(cfg, [key])
        seen.append(cfg.amb_hits_per_read)
    assert seen == [0.25, 0.5, 1.0, 2.0, 4.0, 6, 6]   # cap 2 * K
    # at the cap nothing changes: the runner then stops escalating
    assert _escalate_config(cfg, ["amb_overflow"]) is cfg
    # only its own counter moves it
    assert _escalate_config(GenoConfig(), ["act_overflow"]) \
        .amb_hits_per_read == 0.25
