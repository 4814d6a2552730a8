"""The port's sharded dictionary (``dist/sharded_dict.py``) on the CPU,
against the JAX package on the same numpy-built small index, exactly:

- ``partition_index`` + ``place_shards`` at D = 1, 2, 3 and 8: the shard
  tensors (the port's int64 search keys against the JAX hi / lo columns,
  the meta words), owned and total rows, the plan;
- one shard's block bounds and block scans against the JAX ``_ShardLocal``
  called outside ``shard_map``;
- the D = 2 runner against the JAX D = 2 runner (counts, stat keys);
- the golden VCF at D = 1, 2 and 4, after forced ``route_overflow``
  escalation, and after a single-device checkpoint resumed on D = 2.

Every mesh here is host shards (``["cpu"] * D``), each shard on a thread of
its own, meeting at every all-to-all."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_index_share import FIX, head_fastq, jax_view, small_index

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.dist import sharded_dict as j_sd
from vargeno_tpu.dist.sharding import make_mesh as j_make_mesh
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.dist import sharded_dict as sd
from vargeno_tpu_torch.dist.sharding import make_mesh
from vargeno_tpu_torch.engine import search
from vargeno_tpu_torch.engine.batch import PORT_ONLY_STATS
from vargeno_tpu_torch.engine.geno import GenoRunner

torch.set_num_threads(2)

FQ = os.path.join(FIX, "reads.fq")
VCF = os.path.join(FIX, "snps.vcf")
GOLDEN = open(os.path.join(FIX, "golden_output.vcf")).read()
BASE = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)


@pytest.fixture(scope="module")
def index():
    return small_index()


@pytest.fixture(scope="module")
def j_index(index):
    return jax_view(index)


def _mesh(D):
    return make_mesh(devices=["cpu"] * D)


def _golden_run(runner, tmp_path, fq=FQ):
    runner.consume_fastq(fq)
    out = str(tmp_path / "out.vcf")
    runner.write_vcf(VCF, out)
    bad = {k: v for k, v in runner.stats_totals.items()
           if "overflow" in k and v}
    assert not bad, bad
    return open(out).read()


@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_partition_matches_jax(index, j_index, D):
    part = sd.partition_index(index, D)
    shards = sd.place_shards(part, _mesh(D))
    _, jst, jplan, jowned, jtotals = j_sd.partition_index(j_index, D)
    np.testing.assert_array_equal(part.plan.ref_bounds_hi,
                                  np.asarray(jplan.ref_bounds_hi))
    np.testing.assert_array_equal(part.plan.snp_bounds_hi24,
                                  np.asarray(jplan.snp_bounds_hi24))
    for k in ("ref", "snp"):
        np.testing.assert_array_equal(part.owned[k], jowned[k])
        np.testing.assert_array_equal(part.totals[k], jtotals[k])
    for d, sh in enumerate(shards):
        for k in ("ref", "snp"):
            np.testing.assert_array_equal(
                getattr(sh, k + "_key").numpy(),
                search.np_okey(jst[k + "_hi"][d], jst[k + "_lo"][d]))
            np.testing.assert_array_equal(
                getattr(sh.dix, k + "_meta").numpy().view(np.uint32),
                jst[k + "_meta"][d])
        # the scans' test words come out of the key: equal on every real
        # row (the JAX pad rows of snp_test hold 0xFFFFFFFF where hi & 0xFF
        # is 0xFF)
        n = part.totals["snp"][d]
        hi, lo = search.key_hi(sh.snp_key), search.key_lo(sh.snp_key)
        np.testing.assert_array_equal(lo[:n].numpy(),
                                      jst["snp_test"][d, :n, 0])
        np.testing.assert_array_equal((hi[:n] & 0xFF).numpy(),
                                      jst["snp_test"][d, :n, 1])


def _j_shard_local(j_index, D, d):
    base, jst, _, jowned, jtotals = j_sd.partition_index(j_index, D)
    dix = dataclasses.replace(base, **{
        f: jnp.asarray(jst[f][d]) for f in (
            "ref_hi", "ref_lo", "ref_meta", "snp_hi", "snp_lo", "snp_meta",
            "snp_test")})
    return j_sd._ShardLocal(dix, True, 100, int(jowned["ref"][d]),
                            int(jowned["snp"][d]), int(jtotals["ref"][d]),
                            int(jtotals["snp"][d]))


def _queries(index, rng, n=3000):
    """Query k-mers: dictionary keys with one base changed (hits of the
    scans), the keys themselves, and random words."""
    k = np.concatenate([index.ref.kmers, index.snp.kmers])
    q = k[rng.integers(0, k.size, n)].astype(np.uint64)
    sh = (2 * rng.integers(0, 20, n)).astype(np.uint64)
    mut = rng.random(n) < 0.7
    q[mut] ^= (np.uint64(1) << sh[mut])
    q[-200:] = rng.integers(0, 2**63, 200, dtype=np.uint64)
    return ((q >> np.uint64(32)).astype(np.uint32),
            (q & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            rng.random(n) < 0.9)


@pytest.mark.parametrize("D,d", [(2, 0), (2, 1), (3, 2)])
def test_shard_local_matches_jax(index, j_index, D, d):
    jl = _j_shard_local(j_index, D, d)
    shard = sd.place_shards(sd.partition_index(index, D), _mesh(D))[d]
    pl = sd._ShardLocal(shard, True, 100)
    qh, ql, act = _queries(index, np.random.default_rng(D * 10 + d))
    q24 = qh >> np.uint32(8)
    t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    # (start, size); a start past the shard's rows (size 0) is the JAX
    # loop's n + 1 where the search form gives n (engine/search.py)
    for got, want, m in ((pl._ref_block_bounds(t(qh)),
                          jl._ref_block_bounds(jnp.asarray(qh)),
                          shard.ref_key.numel()),
                         (pl._snp_block_bounds(t(q24)),
                          jl._snp_block_bounds(jnp.asarray(q24)),
                          shard.snp_key.numel())):
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.minimum(np.asarray(want[0]), m))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for name in ("ref_scan", "snp_scan"):
        g = getattr(pl, name)(t(qh), t(ql), torch.from_numpy(act))
        w = getattr(jl, name)(jnp.asarray(qh), jnp.asarray(ql),
                              jnp.asarray(act))
        assert int(np.asarray(w.hit).sum()) > 0, name   # the scans hit
        for f in ("hit", "pos", "flag", "info", "nb_hi", "nb_lo", "diff",
                  "overflow"):
            np.testing.assert_array_equal(
                getattr(g, f).numpy().astype(np.int64),
                np.asarray(getattr(w, f)).astype(np.int64), err_msg=name + f)


def test_d2_runner_matches_jax_d2(index, j_index, tmp_path):
    fq = head_fastq(FQ, str(tmp_path / "head.fq"), 2048)
    cfg = dict(BASE, batch_reads=256)
    port = sd.ShardedDictGenoRunner(index, _mesh(2), GenoConfig(**cfg))
    port.consume_fastq(fq)
    jrun = j_sd.ShardedDictGenoRunner(j_index, j_make_mesh(2), JConfig(**cfg))
    jrun.consume_fastq(fq)
    rc, ac = port.host_counts()
    j_rc, j_ac = jrun._host_counts()
    np.testing.assert_array_equal(rc, j_rc)
    np.testing.assert_array_equal(ac, j_ac)
    assert rc.sum() + ac.sum() > 0
    # the port's own stats: on this input nothing spills
    assert port.stats_totals["amb_overflow"] == 0
    assert sorted(k for k in port.stats_totals
                  if k not in PORT_ONLY_STATS) == sorted(jrun.stats_totals)
    assert "route_overflow" in port.stats_totals
    for k in ("n_processed", "lowq_n", "probe_hits", "retry_n"):
        assert port.stats_totals[k] == jrun.stats_totals[k], k
    assert (port.n_reads, port.n_retry_reads) == (jrun.n_reads,
                                                  jrun.n_retry_reads)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_golden_at_d(index, tmp_path, D):
    cfg = GenoConfig(**BASE)
    runner = sd.ShardedDictGenoRunner(index, _mesh(D), cfg)
    assert _golden_run(runner, tmp_path) == GOLDEN
    assert runner.device_bytes() > 0


def test_tiny_route_caps_escalate_to_golden(index, tmp_path):
    cfg = GenoConfig(**BASE, route_factor=0.05, auto_retry_max=8)
    runner = sd.ShardedDictGenoRunner(index, _mesh(2), cfg)
    assert _golden_run(runner, tmp_path) == GOLDEN
    assert runner._cfg_run.route_factor > cfg.route_factor
    assert runner.n_escalations > 0


def test_single_device_checkpoint_resumes_sharded(index, tmp_path):
    ck = str(tmp_path / "ck")
    first = GenoRunner(index, GenoConfig(**BASE), device="cpu")
    first.consume_fastq(FQ, limit_batches=6, checkpoint_path=ck,
                        checkpoint_every=3)
    assert 0 < first.n_reads < 20000
    resumed = sd.ShardedDictGenoRunner(
        index, _mesh(2), GenoConfig(**dict(BASE, batch_reads=256)))
    resumed.consume_fastq(FQ, checkpoint_path=ck)
    out = str(tmp_path / "out.vcf")
    resumed.write_vcf(VCF, out)
    assert open(out).read() == GOLDEN
    assert resumed.n_reads == 20443


def test_partition_refuses_oversized_shards(index, monkeypatch):
    """The 2^31-row shard limit (the JAX message), shown on the small index
    by lowering the limit below its row count."""
    monkeypatch.setattr(sd, "SHARD_ROWS_MAX", 1000)
    n = index.ref.kmers.size
    with pytest.raises(ValueError, match="2\\^31-row per-device limit") as e:
        sd.partition_index(index, 2)
    assert f"need >= {-(-n // 1000)}" in str(e.value)
