"""The port's data-parallel mesh runner (``dist/sharding.py``) on the CPU:
per-site counts equal to the single-device GenoRunner's at D = 1, 2 and 4,
the routed caps' escalation against the JAX package's, the per-shard stats
aggregation, cohort on a mesh against single runs, the
mesh collective itself, a failing or stalled shard ending in an error
within the mesh's timeout, the refusals of ``make_mesh`` and the CLI's
``--mesh``. Every mesh is host shards (``["cpu"] * D``); the small index
keeps memory low."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch_index_share import FIX, small_index

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.engine.geno import _escalate_config as j_escalate
from vargeno_tpu_torch import cli
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
from vargeno_tpu_torch.dist.sharding import (Mesh, ShardedGenoRunner,
                                             make_mesh)
from vargeno_tpu_torch.engine.cohort import CohortRunner
from vargeno_tpu_torch.engine.geno import (Fetch, GenoRunner, _encoder,
                                           _escalate_config, step_vec,
                                           unpack_vec)
from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.io.fastq import iter_read_batches

torch.set_num_threads(2)

FQ = os.path.join(FIX, "reads.fq")
VCF = os.path.join(FIX, "snps.vcf")
GOLDEN = open(os.path.join(FIX, "golden_output.vcf")).read()
BASE = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)


@pytest.fixture(scope="module")
def index():
    return small_index()


@pytest.fixture(scope="module")
def single_counts(index):
    r = GenoRunner(index, GenoConfig(**BASE), device="cpu")
    r.consume_fastq(FQ)
    return r.host_counts(), r.stats_totals


def _mesh(D, **kw):
    return make_mesh(devices=["cpu"] * D, **kw)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_mesh_counts_equal_single_device(index, single_counts, D):
    (rc, ac), st = single_counts
    runner = ShardedGenoRunner(index, _mesh(D), GenoConfig(**BASE))
    runner.consume_fastq(FQ)
    m_rc, m_ac = runner.host_counts()
    np.testing.assert_array_equal(m_rc, rc)
    np.testing.assert_array_equal(m_ac, ac)
    assert runner.stats_totals["n_processed"] == st["n_processed"]
    assert sorted(runner.stats_totals) == sorted(st)
    assert len(runner.ref_cnt) == D and runner.n_reads == 20443


@pytest.mark.parametrize("tripped", [
    ["route_overflow"], ["snp_scan_overflow"], ["fwd_snp_scan_overflow",
                                                "rev_route_overflow"],
    ["event_overflow", "route_overflow", "cand_overflow"]])
def test_escalation_matches_jax(tripped):
    """The routed caps escalate as the JAX package's do, from the defaults
    and from near their limits."""
    for kw in ({}, dict(route_factor=40.0, route_scan_slots=80)):
        got = _escalate_config(GenoConfig(**kw), tripped)
        want = j_escalate(JConfig(**kw), tripped)
        for f in ("route_factor", "route_scan_slots", "scan_slot_cap",
                  "scan_active_frac", "events_per_read",
                  "candidates_per_read"):
            assert getattr(got, f) == getattr(want, f), (tripped, kw, f)


def test_per_shard_stats_aggregate(index):
    """``_issue`` + ``_settle``: ``*_max`` keys take the max over shards,
    the others the sum; auto-tune sees each key's largest single-shard
    value; the masks are the shards' in order."""
    D = 2
    cfg = GenoConfig(**BASE)
    runner = ShardedGenoRunner(index, _mesh(D), cfg)
    b = next(iter(iter_read_batches(FQ, D * cfg.batch_reads,
                                    cfg.max_read_len, 4)))
    args = runner._upload(_encoder(4)(b.codes, b.n_kmers), b.qual)
    procs = runner._proc(cfg)
    _, _, keys, vecs = runner._issue(procs, args, "enc",
                                     (runner.ref_cnt, runner.alt_cnt))
    stats, tune, (process, read_ok) = runner._settle(
        keys, Fetch(vecs).result(), (cfg.batch_reads,))
    rows, masks = [], []
    for r in range(D):
        _, _, keys, vec = step_vec(procs[r], args[r], "enc",
                                   runner.ref_cnt[r], runner.alt_cnt[r])
        row, m = unpack_vec(Fetch([vec]).result()[0], keys,
                            cfg.batch_reads)
        rows.append(row)
        masks.append(m)
    for k in keys:
        vals = [row[k] for row in rows]
        assert stats[k] == (max(vals) if k.endswith("_max") else sum(vals))
        assert tune[k] == max(vals)
    assert any(stats[k] != sum(row[k] for row in rows)
               for k in keys if k.endswith("_max"))
    np.testing.assert_array_equal(process, np.concatenate(
        [m[0] for m in masks]))
    np.testing.assert_array_equal(read_ok, np.concatenate(
        [m[1] for m in masks]))


def test_cohort_on_mesh_matches_single_runs(index, tmp_path):
    lines = open(FQ).read().splitlines(keepends=True)
    recs = [lines[i:i + 4] for i in range(0, len(lines), 4)]
    paths = []
    for s in range(2):
        p = str(tmp_path / f"s{s}.fq")
        with open(p, "w") as f:
            for rec in recs[s::2]:
                f.writelines(rec)
        paths.append(p)
    cohort = CohortRunner(index, ["a", "b"], GenoConfig(**BASE),
                          mesh=_mesh(2))
    for name, fq in zip("ab", paths):
        cohort.consume_sample(name, fq)
    outs = cohort.write_vcfs(VCF, str(tmp_path / "c_{sample}.vcf"))
    for fq, out in zip(paths, outs):
        r = GenoRunner(index, GenoConfig(**BASE), device="cpu")
        r.consume_fastq(fq)
        ref = str(tmp_path / "single.vcf")
        r.write_vcf(VCF, ref)
        assert open(out).read() == open(ref).read()


@pytest.mark.parametrize("D,rounds", [(3, 1), (min(16, os.cpu_count() + 2),
                                         40)])
def test_all_to_all_exchanges_rows(D, rounds):
    """Every shard gets row r of every peer's buffer, round after round; the
    second case runs more shard threads than cores with a short switch
    interval, where a stale or overwritten slot would show as a wrong
    round or source."""
    mesh = _mesh(D, timeout=60)

    def shard(r):
        got = []
        for k in range(rounds):
            buf = (torch.arange(D)[:, None] * 10 + 1000 * r + 100000 * k
                   ).expand(D, 3).contiguous()
            got.append(mesh.all_to_all(r, buf))
        return got

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = mesh.run_lockstep([lambda r=r: shard(r) for r in range(D)])
    finally:
        sys.setswitchinterval(old)
    for r, got in enumerate(outs):
        for k, out in enumerate(got):
            want = (torch.arange(D)[:, None] * 1000 + 10 * r + 100000 * k
                    ).expand(D, 3)
            assert torch.equal(out, want), (r, k)


class _FaultyMesh(Mesh):
    """A host mesh whose shard 1 raises (or stalls) at its third
    all-to-all."""

    def __init__(self, D, timeout, stall=0.0):
        super().__init__(["cpu"] * D, timeout)
        self.stall = stall
        self.calls = 0
        self._lock = threading.Lock()

    def all_to_all(self, rank, buf):
        if rank == 1:
            with self._lock:
                self.calls += 1
                n = self.calls
            if n == 3:
                if not self.stall:
                    raise ValueError("injected shard failure")
                time.sleep(self.stall)
        return super().all_to_all(rank, buf)


def _shard_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("mesh-shard-")]


def test_failing_shard_raises_within_timeout(index):
    mesh = _FaultyMesh(2, timeout=20)
    runner = ShardedDictGenoRunner(index, mesh, GenoConfig(**BASE))
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="injected shard failure"):
        runner.consume_fastq(FQ)
    assert time.monotonic() - t0 < 20
    assert not _shard_threads()


def test_stalled_shard_times_out(index):
    mesh = _FaultyMesh(2, timeout=1.0, stall=4.0)
    runner = ShardedDictGenoRunner(index, mesh, GenoConfig(**BASE))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        runner.consume_fastq(FQ)
    assert time.monotonic() - t0 < 4.0
    for t in _shard_threads():   # the stalled shard then meets the abort
        t.join(10)
        assert not t.is_alive()


def test_make_mesh_refusals():
    with pytest.raises(ValueError, match="2 shards asked for"):
        make_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (test_torch_gpu.py covers "
                    "the count check)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)


def test_cli_mesh_cpu_matches_golden(index, tmp_path):
    prefix = str(tmp_path / "idx")
    store.save(prefix, index)
    for extra in (["--mesh", "2", "--sharded-dict"], ["--mesh", "2"]):
        out = str(tmp_path / "cli.vcf")
        rc = cli.main(["geno", prefix, FQ, VCF, out, "--device", "cpu",
                       "--batch-reads", "512", "--no-auto-tune"] + extra)
        assert rc == 0
        assert open(out).read() == GOLDEN, extra
    out = str(tmp_path / "cohort_{sample}.vcf")
    rc = cli.main(["cohort", prefix, VCF, out, f"a={FQ}", "--device", "cpu",
                   "--batch-reads", "512", "--mesh", "2"])
    assert rc == 0
    assert open(out.format(sample="a")).read() == GOLDEN


def test_cli_mesh_refusals(tmp_path, capsys):
    args = ["geno", str(tmp_path / "idx"), FQ, VCF, str(tmp_path / "x.vcf")]
    assert cli.main(args + ["--device", "cpu", "--sharded-dict"]) == 1
    assert "--sharded-dict needs it" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(args + ["--mesh", "2"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.vcf").exists()
