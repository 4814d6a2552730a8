"""The port's host dispatch pipeline (``engine/geno.py``: in-flight handles
synced by a fetch worker, chained totals that rewind on escalation, grouped
dispatch, the codes path) on the CPU: the port's GenoRunner at several
(pipeline_depth, group_size) points against the JAX GenoRunner at the same
knobs and the golden VCF; ``multi_enc`` and ``single`` against
``single_enc``; escalation with batches in flight and in a group;
auto-tune, checkpoint and resume, the mesh runners and two gloo processes
under the pipeline; the CLI flags and the fuzzer's drawn knobs. Counts are
held exactly. The index is ``torch_index_share.small_index``."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from test_torch_multihost import _cluster
from torch_index_share import FIX, head_fastq, jax_view, small_index

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.engine.device_index import \
    build_device_index as j_build_device_index
from vargeno_tpu.engine.geno import GenoRunner as JRunner
from vargeno_tpu_torch import cli
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
from vargeno_tpu_torch.dist.sharding import ShardedGenoRunner, make_mesh
from vargeno_tpu_torch.engine import checkpoint as ckpt
from vargeno_tpu_torch.engine.batch import make_batch_processor
from vargeno_tpu_torch.engine.device_index import build_device_index
from vargeno_tpu_torch.engine.geno import GenoRunner, _encoder, upload
from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.io.fastq import iter_read_batches
from vargeno_tpu_torch.tools import fuzz_diff

torch.set_num_threads(2)

FQ = os.path.join(FIX, "reads.fq")
VCF = os.path.join(FIX, "snps.vcf")
GOLDEN = open(os.path.join(FIX, "golden_output.vcf")).read()
BASE = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
# the first batch trips these, with later batches in flight
TINY = dict(events_per_read=4, agree_cap=1, auto_retry_max=6)


@pytest.fixture(scope="module")
def index():
    return small_index()


@pytest.fixture(scope="module")
def dix(index):
    return build_device_index(index, "cpu", GenoConfig().ht_target_load)


@pytest.fixture(scope="module")
def jdix(index):
    return j_build_device_index(jax_view(index),
                                ht_target_load=JConfig().ht_target_load)


def _port(index, dix, cfg, fq=FQ, **kw):
    runner = GenoRunner(index, cfg, device="cpu", dix=dix)
    runner.consume_fastq(fq, **kw)
    return runner


class _SharedSteps(dict):
    """The JAX runners' batch processors, shared by every JAX runner of
    this file and keyed by their config without the pipeline knobs (which
    the step does not read), so that each step compiles once."""

    @staticmethod
    def _key(cfg):
        return dataclasses.replace(cfg, pipeline_depth=1, group_size=1)

    def get(self, cfg, default=None):
        return super().get(self._key(cfg), default)

    def __setitem__(self, cfg, proc):
        super().__setitem__(self._key(cfg), proc)


JAX_STEPS = _SharedSteps()


def _jax(index, jdix, **kw):
    runner = JRunner(jax_view(index), JConfig(**BASE, **kw), dix=jdix)
    runner._procs = JAX_STEPS
    runner.consume_fastq(FQ)
    return runner


def _vcf(runner, tmp_path):
    out = str(tmp_path / "out.vcf")
    runner.write_vcf(VCF, out)
    return open(out).read()


def _no_overflow(runner):
    return not any(v for k, v in runner.stats_totals.items()
                   if "overflow" in k)


def _same_counts(runner, jrun):
    rc, ac = runner.host_counts()
    np.testing.assert_array_equal(rc, np.asarray(jrun.ref_cnt))
    np.testing.assert_array_equal(ac, np.asarray(jrun.alt_cnt))
    assert runner.n_reads == jrun.n_reads


@pytest.mark.parametrize("depth,group", [(1, 1), (2, 1), (3, 1), (2, 3),
                                         (3, 4)])
def test_runner_equals_jax_at_the_same_knobs(index, dix, jdix, tmp_path,
                                             depth, group):
    knobs = dict(pipeline_depth=depth, group_size=group)
    runner = _port(index, dix, GenoConfig(**BASE, **knobs))
    assert _vcf(runner, tmp_path) == GOLDEN
    assert _no_overflow(runner), runner.stats_totals
    assert runner.meter.reads == runner.n_reads == 20443
    _same_counts(runner, _jax(index, jdix, **knobs))


def test_codes_path_matches_golden(index, dix, tmp_path):
    """``pre_encode=False``: base codes shipped, encoded by the step
    (``BatchProcessor.single``); groups are not formed."""
    runner = _port(index, dix, GenoConfig(**BASE, pre_encode=False,
                                          group_size=3))
    assert _vcf(runner, tmp_path) == GOLDEN
    assert _no_overflow(runner)
    assert runner.meter.batches == 60   # 40 forward + 20 retry, no group
    ref = _port(index, dix, GenoConfig(**BASE, pipeline_depth=1))
    for a, b in zip(runner.host_counts(), ref.host_counts()):
        np.testing.assert_array_equal(a, b)
    assert runner.n_retry_reads == ref.n_retry_reads


def _host_batches(n, B=256):
    enc = _encoder(4)
    out = []
    for b in iter_read_batches(FQ, B, 128, 4):
        out.append((b, enc(b.codes, b.n_kmers)))
        if len(out) == n:
            return out


def test_multi_enc_equals_sequential_single_enc(dix):
    """G stacked batches: counts, the reduced stats (``*_max`` the max,
    the rest the sum) and the (G, B) masks of G single_enc steps."""
    cfg = GenoConfig(**dict(BASE, batch_reads=256))
    proc = make_batch_processor(dix, cfg)
    batches = _host_batches(3)
    z = torch.zeros(dix.n_sites + 1, dtype=torch.int32)
    rc, ac = z, z.clone()
    rows, procs, oks = [], [], []
    for b, e in batches:
        rc, ac, p, r, st = proc.single_enc(*upload("cpu", e, b.qual), rc, ac)
        rows.append({k: int(v) for k, v in st.items()})
        procs.append(p)
        oks.append(r)
    stack = [np.stack(a) for a in zip(*(e for _, e in batches))]
    args = upload("cpu", stack, np.stack([b.qual for b, _ in batches]))
    grc, gac, gp, gr, gst = proc.multi_enc(*args, z, z.clone())
    assert torch.equal(grc, rc) and torch.equal(gac, ac)
    assert torch.equal(z, torch.zeros_like(z))   # inputs untouched
    assert torch.equal(gp, torch.stack(procs))
    assert torch.equal(gr, torch.stack(oks))
    assert gp.shape == (3, 256)
    for k, v in gst.items():
        col = [r[k] for r in rows]
        assert int(v) == (max(col) if k.endswith("_max") else sum(col)), k
    assert any(max(r[k] for r in rows) != sum(r[k] for r in rows)
               for k in gst if k.endswith("_max"))


def test_single_from_codes_equals_single_enc(dix):
    cfg = GenoConfig(**dict(BASE, batch_reads=256))
    proc = make_batch_processor(dix, cfg)
    b, e = _host_batches(1)[0]
    z = torch.zeros(dix.n_sites + 1, dtype=torch.int32)
    want = proc.single_enc(*upload("cpu", e, b.qual), z, z.clone())
    got = proc.single(torch.from_numpy(b.codes), torch.from_numpy(b.n_kmers),
                      torch.from_numpy(b.qual), z, z.clone())
    for a, c in zip(want[:4], got[:4]):
        assert torch.equal(a, c)
    assert {k: int(v) for k, v in want[4].items()} == \
        {k: int(v) for k, v in got[4].items()}


@pytest.fixture(scope="module")
def tiny_depth1(index, dix):
    return _port(index, dix, GenoConfig(**BASE, **TINY, pipeline_depth=1))


@pytest.fixture(scope="module")
def tiny_jax(index, jdix):
    return _jax(index, jdix, **TINY, pipeline_depth=3, group_size=3)


@pytest.mark.parametrize("group", [1, 3], ids=["depth3", "depth3-group3"])
def test_escalation_in_flight_rewinds(index, dix, tiny_depth1, tiny_jax,
                                      tmp_path, group):
    """The first batch (or group) trips while later ones are in flight:
    the rewind restores its input totals and redoes it and every later
    one. Counts equal the depth-1 run's and the JAX runner's."""
    runner = GenoRunner(index, GenoConfig(**BASE, **TINY, pipeline_depth=3,
                                          group_size=group), device="cpu",
                        dix=dix)
    first, redone = [], []
    settle, rewind = runner._settle, runner._chain_rewind

    def settled(*a):
        out = settle(*a)
        first.append(any(v for k, v in out[0].items() if "overflow" in k))
        return out

    def rewound(p):
        redone.append(len(runner._inflight) - 1)   # p is the head
        return rewind(p)
    runner._settle, runner._chain_rewind = settled, rewound
    runner.consume_fastq(FQ)
    assert first[0] and redone[0] >= 2
    assert runner.n_rewinds >= 1 and runner.n_escalations > 0
    assert _no_overflow(runner)
    assert not runner._inflight
    for a, b in zip(runner.host_counts(), tiny_depth1.host_counts()):
        np.testing.assert_array_equal(a, b)
    _same_counts(runner, tiny_jax)
    assert _vcf(runner, tmp_path) == GOLDEN


def test_auto_tune_in_flight_matches_golden(index, dix, tmp_path):
    runner = _port(index, dix, GenoConfig(**BASE, auto_tune=True,
                                          tune_batches=1, pipeline_depth=2))
    assert runner._tuned and runner._cfg_run != runner.config
    assert _no_overflow(runner)
    assert _vcf(runner, tmp_path) == GOLDEN


def test_checkpoint_resume_at_depth_and_group(index, dix, tmp_path):
    """Depth 2, groups of 2: a run stopped after 7 batches resumes to the
    uninterrupted counts, and every checkpoint it wrote holds exactly the
    reads before its offset (nothing queued or in flight left out)."""
    cfg = GenoConfig(**BASE, pipeline_depth=2, group_size=2)
    whole = _port(index, dix, cfg)
    path = str(tmp_path / "ck")
    saves = []
    leg = GenoRunner(index, cfg, device="cpu", dix=dix)
    save = leg._ckpt_save

    def saved(p):
        save(p)
        rc, ac, meta = ckpt.load(p)
        saves.append((meta["n_reads"], rc, ac))
    leg._ckpt_save = saved
    leg.consume_fastq(FQ, limit_batches=7, checkpoint_path=path,
                      checkpoint_every=3)
    assert len(saves) >= 2 and 0 < saves[-1][0] < 20443
    for n, rc, ac in saves[:2]:
        head = _port(index, dix, cfg,
                     head_fastq(FQ, str(tmp_path / f"h{n}.fq"), n))
        hrc, hac = head.host_counts()
        np.testing.assert_array_equal(rc, hrc)
        np.testing.assert_array_equal(ac, hac)
    resumed = _port(index, dix, cfg, checkpoint_path=path)
    assert resumed.n_reads == 20443
    for a, b in zip(resumed.host_counts(), whole.host_counts()):
        np.testing.assert_array_equal(a, b)
    assert _vcf(resumed, tmp_path) == GOLDEN


def _kinds(runner) -> list:
    """The kinds of the dispatches ``runner`` makes, filled in as it
    runs."""
    seen = []
    dispatch = runner._dispatch

    def counted(kind, args):
        seen.append(kind)
        return dispatch(kind, args)
    runner._dispatch = counted
    return seen


def test_replicated_mesh_group4_matches_golden(index, tmp_path):
    runner = ShardedGenoRunner(index, make_mesh(devices=["cpu"] * 2),
                               GenoConfig(**BASE, group_size=4))
    kinds = _kinds(runner)
    runner.consume_fastq(FQ)
    assert "group" in kinds
    assert _no_overflow(runner)
    assert _vcf(runner, tmp_path) == GOLDEN


def test_mesh_chain_rewinds_every_shard(index, tmp_path):
    """The mesh chains each shard's totals: tiny caps at depth 3 rewind
    both shards and still match golden."""
    runner = ShardedGenoRunner(index, make_mesh(devices=["cpu"] * 2),
                               GenoConfig(**BASE, **TINY, pipeline_depth=3))
    runner.consume_fastq(FQ)
    assert runner.n_rewinds >= 1 and _no_overflow(runner)
    assert _vcf(runner, tmp_path) == GOLDEN


def test_sharded_dict_depth2_escalates_to_golden(index, tmp_path):
    cfg = GenoConfig(**BASE, pipeline_depth=2, route_factor=0.05,
                     auto_retry_max=8)
    runner = ShardedDictGenoRunner(index, make_mesh(devices=["cpu"] * 2),
                                   cfg)
    runner.consume_fastq(FQ)
    assert runner._cfg_run.route_factor > cfg.route_factor
    assert runner.n_escalations > 0 and _no_overflow(runner)
    assert _vcf(runner, tmp_path) == GOLDEN


@pytest.fixture(scope="module")
def prefix(index, tmp_path_factory):
    p = str(tmp_path_factory.mktemp("pipe_idx") / "mini")
    store.save(p, index)
    return p


@pytest.mark.parametrize("extra", [(), ("--sharded-dict",),
                                   ("--sharded-dict", "--events-per-read",
                                    "4", "--agree-cap", "1")],
                         ids=["replicated", "sharded-dict",
                              "sharded-dict-escalating"])
def test_two_gloo_processes_depth2_match_golden(prefix, tmp_path, extra):
    assert _cluster(prefix, tmp_path,
                    ("--pipeline-depth", "2") + extra) == GOLDEN


def test_cli_flags_reach_the_config():
    ap = cli._parser()
    args = ap.parse_args(["geno", "p", FQ, VCF, "o.vcf", "--device", "cpu",
                          "--group-size", "3", "--pipeline-depth", "4",
                          "--no-pre-encode"])
    cfg = cli._config(args, [FQ])
    assert (cfg.group_size, cfg.pipeline_depth, cfg.pre_encode) == (3, 4,
                                                                    False)
    dflt = cli._config(ap.parse_args(["geno", "p", FQ, VCF, "o.vcf"]), [FQ])
    assert (dflt.group_size, dflt.pipeline_depth, dflt.pre_encode) == \
        (1, 2, True) == (JConfig().group_size, JConfig().pipeline_depth,
                         JConfig().pre_encode)
    co = ap.parse_args(["cohort", "p", VCF, "o_{sample}.vcf", f"a={FQ}",
                        "--group-size", "2", "--pipeline-depth", "3"])
    assert (co.group_size, co.pipeline_depth) == (2, 3)


def test_cli_no_pre_encode_on_a_mesh_is_overridden(index, prefix, tmp_path):
    runner = ShardedGenoRunner(index, make_mesh(devices=["cpu"] * 2),
                               GenoConfig(**BASE, pre_encode=False))
    assert runner.config.pre_encode
    out = str(tmp_path / "cli.vcf")
    assert cli.main(["geno", prefix, FQ, VCF, out, "--device", "cpu",
                     "--batch-reads", "512", "--mesh", "2",
                     "--no-pre-encode", "--group-size", "2"]) == 0
    assert open(out).read() == GOLDEN


@pytest.mark.parametrize("seed", [4, 15])
def test_fuzz_seeds_run_their_drawn_knobs(seed, tmp_path):
    """Seed 4 draws groups of 3 at depth 2 (B = 64, E = 16: it
    escalates), seed 15 groups of 3 at depth 1 (B = 64): the runner takes
    them and a group is dispatched."""
    case = fuzz_diff.draw_case(seed, big=False)
    knobs = (case["config"]["group_size"], case["config"]["pipeline_depth"])
    assert knobs == {4: (3, 2), 15: (3, 1)}[seed]
    seen = []

    def make(index, config, device, queued):
        runner = fuzz_diff.geno_runner(index, config, device, queued)
        seen.extend([runner.config, _kinds(runner)])
        return runner
    got = fuzz_diff.run_seed(seed, "cpu", make, tmpdir=str(tmp_path))
    assert got["ok"] and got["mismatches"] == 0 and not got["overflow"]
    config, kinds = seen
    assert (config.group_size, config.pipeline_depth) == knobs
    assert "group" in kinds
