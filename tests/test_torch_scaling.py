"""The port's scaling tools (``tools/bench_scaling.py``,
``tools/bench_scaling_mh.py``) on the CPU: each point's runner counts equal
to the JAX mesh runner's after the same warm batch and timed batches, the
point list and result keys equal to the JAX tool's, the multi-process tool
on a gloo cluster of two processes, and its refusals before any worker
starts. Datasets stay at the JAX tool's 2 Mb / 5,000 SNPs or below."""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_index_share import jax_view

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.dist.sharded_dict import \
    ShardedDictGenoRunner as JDictRunner
from vargeno_tpu.dist.sharding import ShardedGenoRunner as JRunner
from vargeno_tpu.dist.sharding import make_mesh as j_make_mesh
from vargeno_tpu_torch.testing import make_synthetic
from vargeno_tpu_torch.tools import bench_scaling, bench_scaling_mh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, BATCHES = 256, 2
# (mode, devices) of the JAX tool's points at --devices 2
POINTS = [("dp", 1), ("dp", 2), ("routed", 2)]
JAX_KEYS = {"mode", "devices", "reads_per_sec", "per_device", "efficiency"}
MH_JAX_KEYS = {"mode", "procs", "devices", "reads_per_sec"}
TOOL_ARGS = ["--devices", "2", "--batches", "1", "--batch-reads", "256"]


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A 200 kb / 500-SNP draw of the tool's generator (its seed) with
    enough reads for the warm batch and the timed ones at D = 2."""
    index, _, _, fq = make_synthetic(
        seed=123, tmpdir=str(tmp_path_factory.mktemp("scaling")),
        sizes=(200_000,), n_snps=500, n_reads=BATCH * 2 * (BATCHES + 1))
    return index, fq


def _env(tmp_path, **extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path),
               **extra)
    env.pop("PYTHONPATH", None)
    return env


def _results(stdout: str) -> list:
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode,D", POINTS)
def test_point_counts_equal_jax_runner(synthetic, mode, D):
    """run_point's runner holds exactly the JAX mesh runner's counts after
    the same consume sequence (a warm batch, then BATCHES from the start
    of the file), and its result the tool's keys."""
    index, fq = synthetic
    cfg = bench_scaling.point_config(BATCH)
    got, runner = bench_scaling.run_point(index, fq, mode, ["cpu"] * D, cfg,
                                          BATCHES)
    jcfg = JConfig(batch_reads=BATCH, max_read_len=128, max_kmers_per_read=4)
    jidx = jax_view(index)
    jrun = (JDictRunner(jidx, j_make_mesh(D), jcfg, route_factor=6.0)
            if mode == "routed" else JRunner(jidx, j_make_mesh(D), jcfg))
    jrun.consume_fastq(fq, limit_batches=1)
    jrun.consume_fastq(fq, limit_batches=BATCHES)
    rc, ac = runner.host_counts()
    j_rc, j_ac = jrun._host_counts()
    np.testing.assert_array_equal(rc, np.asarray(j_rc))
    np.testing.assert_array_equal(ac, np.asarray(j_ac))
    assert rc.sum() + ac.sum() > 0
    assert runner.n_reads == jrun.n_reads == (BATCHES + 1) * BATCH * D
    assert got["reads"] == BATCHES * BATCH * D and got["reads_per_sec"] > 0
    assert got["window_batches"] >= BATCHES
    assert (got["mode"], got["devices"], got["overflow"]) == (mode, D, {})
    assert got["peak_bytes"] == [None]   # one host device, no allocator
    if mode == "routed":
        assert runner._cfg_run.route_factor >= 6.0


def test_point_list_and_keys_equal_jax_tool(tmp_path):
    """The JAX tool and the port's at the same flags: the same (mode,
    devices) points in order, the JAX tool's keys on each point and the
    port's EXTRA_KEYS beside them. (The JAX tool's routed step compiles
    for minutes at XLA's default optimization on a CPU; the level does not
    change what it computes.)"""
    r = subprocess.run(
        [sys.executable, "tools/bench_scaling.py", "--cpu", *TOOL_ARGS],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=_env(tmp_path, XLA_FLAGS="--xla_backend_optimization_level=0"))
    assert r.returncode == 0, r.stderr[-3000:]
    want = _results(r.stdout)
    r = subprocess.run(
        [sys.executable, "-m", "vargeno_tpu_torch.tools.bench_scaling",
         "--cpu", *TOOL_ARGS], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=_env(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    got = _results(r.stdout)
    assert got["metric"] == want["metric"] == "scaling"
    pts = [(p["mode"], p["devices"]) for p in got["results"]]
    assert pts == [(p["mode"], p["devices"]) for p in want["results"]]
    assert pts == POINTS
    for g, w in zip(got["results"], want["results"]):
        assert set(w) == JAX_KEYS
        assert set(g) == JAX_KEYS | set(bench_scaling.EXTRA_KEYS)
        assert g["reads"] == 256 * g["devices"] and not g["overflow"]
    assert [p["efficiency"] for p in got["results"]][::2] == [1.0, 1.0]


def test_multiprocess_tool_on_gloo(tmp_path):
    """Two processes of one host shard each over gloo: one point a mode,
    the JAX tool's keys, and every rank's peak bytes and vote launches."""
    r = subprocess.run(
        [sys.executable, "-m", "vargeno_tpu_torch.tools.bench_scaling_mh",
         "--cpu", "--procs", "2", "--devices-per-proc", "1", "--batches",
         "1", "--batch-reads", "256"], cwd=REPO, capture_output=True,
        text=True, timeout=600, env=_env(tmp_path))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    got = _results(r.stdout)
    assert got["metric"] == "scaling_multiprocess"
    assert [p["mode"] for p in got["results"]] == ["dp", "routed"]
    for p in got["results"]:
        assert set(p) == MH_JAX_KEYS | set(bench_scaling_mh.EXTRA_KEYS)
        assert (p["procs"], p["devices"], p["backend"]) == (2, 2, "gloo")
        assert p["reads_per_sec"] > 0 and p["reads"] == 512
        assert p["peak_bytes"] == [[None], [None]]
        assert len(p["vote_launches"]) == len(p["rank_seconds"]) == 2
        assert p["cards"] == [["cpu"], ["cpu"]] and not p["overflow"]
    assert os.listdir(tmp_path) == ["vgt_mh_scale_torch_256_1536"]


def test_multiprocess_tool_refuses_without_card(tmp_path):
    """Without --cpu and without a card (nccl is the default) the tool
    exits non-zero before any dataset is made or worker started."""
    r = subprocess.run(
        [sys.executable, "-m", "vargeno_tpu_torch.tools.bench_scaling_mh",
         "--procs", "2", "--devices-per-proc", "1"], cwd=REPO,
        capture_output=True, text=True, timeout=300, env=_env(tmp_path))
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("kw,msg", [
    (dict(procs=4), "2 CUDA device(s) are visible"),
    (dict(cards="cuda:0,cuda:0"), "nccl takes one process a card"),
    (dict(devices_per_proc=2, cards="cuda:0"), "1 --cards named"),
    (dict(cpu=True, dist_backend="nccl"), "--cpu runs host shards"),
])
def test_multiprocess_layout_refusals(monkeypatch, kw, msg):
    """Layouts NCCL cannot run are refused, with a message, before any
    worker starts (two visible cards stood in for); a card named twice
    runs only over gloo; by default process p takes cuda:p."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    base = dict(procs=2, devices_per_proc=1, cpu=False, dist_backend=None,
                cards=None)
    with pytest.raises(ValueError, match=re.escape(msg)):
        bench_scaling_mh.cluster_cards(argparse.Namespace(**{**base, **kw}))
    ok = argparse.Namespace(**{**base, "dist_backend": "gloo",
                               "cards": "cuda:0,cuda:0"})
    assert bench_scaling_mh.cluster_cards(ok) == [["cuda:0"], ["cuda:0"]]
    ok = argparse.Namespace(**base)
    assert bench_scaling_mh.cluster_cards(ok) == [["cuda:0"], ["cuda:1"]]


def test_scaling_tool_refuses_without_card(capsys):
    assert bench_scaling.main(["--devices", "1"]) == 1
    assert "no CUDA device is available" in capsys.readouterr().err


def test_efficiency_against_the_first_point():
    pts = bench_scaling.with_efficiency([
        dict(devices=2, reads_per_sec=100.0),
        dict(devices=4, reads_per_sec=170.0)])
    assert [p["efficiency"] for p in pts] == [1.0, 0.85]
    assert bench_scaling.sizes_upto(4) == [1, 2, 4]
    assert bench_scaling.sizes_upto(7) == [1, 2, 4]
