"""Multi-process geno of the port (``dist/multihost.py``) on the CPU over
gloo: clusters of real OS processes running the port's CLI, 2 processes x
2 host shards (``--device cpu --mesh 4``) and 4 processes x 1, each VCF
byte-identical to the reference binary's golden output; a finished run's
merged counts equal to the JAX single-device runner's; checkpoints
crossing process counts and packages; kill / resume at 2 x 2 and 4 x 1;
the process-spanning all-to-all against the single-process mesh's; a
failed peer ending its cluster; the striped reader against the JAX
package's. Every cluster runs under its own time limit."""

import argparse
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_index_share import FIX, head_fastq, jax_view, small_index

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.engine.geno import GenoRunner as JRunner
from vargeno_tpu.io import fastq as j_fastq
from vargeno_tpu_torch import cli
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.dist.sharding import make_mesh
from vargeno_tpu_torch.engine import checkpoint as ckpt
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.io import fastq

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FQ = os.path.join(FIX, "reads.fq")
VCF = os.path.join(FIX, "snps.vcf")
GOLDEN = open(os.path.join(FIX, "golden_output.vcf")).read()
BASE = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
CLUSTER_TIMEOUT = 120   # seconds, each spawned cluster
TINY = ("--events-per-read", "4", "--probe-hit-cap", "2", "--agree-cap", "1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(cmds, timeout=CLUSTER_TIMEOUT):
    """Run one process a command, together; (return codes, outputs). Every
    process is killed if the cluster outlasts ``timeout``."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _geno(prefix, out, port, pid, extra=(), P=2, mesh=4):
    return [sys.executable, "-m", "vargeno_tpu_torch.cli", "geno", prefix,
            FQ, VCF, out, "--device", "cpu", "--batch-reads", "512",
            "--mesh", str(mesh), "--multihost", f"localhost:{port}",
            "--num-processes", str(P), "--process-id", str(pid), *extra]


def _cluster(prefix, tmp_path, extra=(), tag="run", P=2, mesh=4):
    """A P process geno run of ``mesh`` shards in all (2 x 2 by default);
    returns process 0's VCF."""
    out = str(tmp_path / f"{tag}.vcf")
    port = _free_port()
    rcs, outs = _spawn([
        _geno(prefix, out if pid == 0 else
              str(tmp_path / f"{tag}.ignored{pid}.vcf"), port, pid, extra,
              P=P, mesh=mesh) for pid in range(P)])
    assert rcs == [0] * P, "\n".join(o[-3000:] for o in outs)
    for pid in range(1, P):
        assert not os.path.exists(tmp_path / f"{tag}.ignored{pid}.vcf")
    assert "overflow" not in "".join(outs)
    return open(out).read()


@pytest.fixture(scope="module")
def index():
    return small_index()


@pytest.fixture(scope="module")
def prefix(index, tmp_path_factory):
    p = str(tmp_path_factory.mktemp("mh_idx") / "mini")
    store.save(p, index)
    return p


@pytest.fixture(scope="module")
def jax_runs(index, tmp_path_factory):
    """One JAX single-device runner: stopped after 3 batches with a
    checkpoint (kept aside), then resumed to the end. Returns the
    3-batch checkpoint's path and the finished counts."""
    d = tmp_path_factory.mktemp("jax_ck")
    path = str(d / "ck")
    runner = JRunner(jax_view(index), JConfig(**BASE))
    runner.consume_fastq(FQ, limit_batches=3, checkpoint_path=path)
    assert 0 < runner.n_reads < 20443
    for ext in (".npz", ".json"):
        shutil.copy(path + ext, str(d / "ck3") + ext)
    runner.consume_fastq(FQ, checkpoint_path=path)
    assert runner.n_reads == 20443
    return str(d / "ck3"), runner._host_counts()


@pytest.mark.parametrize("extra", [(), ("--mh-inline-dual",),
                                   ("--sharded-dict",), TINY],
                         ids=["queued", "inline-dual", "sharded-dict",
                              "escalation"])
def test_two_processes_golden(prefix, tmp_path, extra):
    """Lockstep queued retry (the default), the inline dual step, the
    sharded dictionary (all-to-all routed across processes) and forced
    capacity overflow (replicated stats escalate identically on both
    processes) all byte-match golden."""
    assert _cluster(prefix, tmp_path, extra) == GOLDEN


def test_four_processes_of_one_shard_golden(prefix, tmp_path):
    """The layout of four cards with a process a card: 4 processes x 1
    host shard of the sharded dictionary (every exchange crosses
    processes, none is a thread's) byte-match golden."""
    assert _cluster(prefix, tmp_path, ("--sharded-dict",), P=4) == GOLDEN


def test_counts_equal_jax_runner(prefix, tmp_path, jax_runs):
    """The merged counts that a finished 2-process sharded-dictionary run
    checkpoints equal the JAX single-device runner's exactly."""
    ck = str(tmp_path / "ck")
    assert _cluster(prefix, tmp_path, ("--sharded-dict", "--checkpoint",
                                       ck)) == GOLDEN
    rc, ac, meta = ckpt.load(ck)
    assert meta["n_reads"] == 20443
    j_rc, j_ac = jax_runs[1]
    np.testing.assert_array_equal(rc, np.asarray(j_rc))
    np.testing.assert_array_equal(ac, np.asarray(j_ac))


def test_checkpoint_resumes_on_one_process(index, prefix, tmp_path):
    """A 2-process run stopped after 3 forward batches holds the merged
    counts of its 3 global batches; a single-process port runner resumes
    it to golden."""
    ck = str(tmp_path / "ck")
    assert _cluster(prefix, tmp_path, ("--checkpoint", ck, "--limit-batches",
                                       "3")) != GOLDEN
    assert ckpt.load(ck)[2]["n_reads"] == 3 * 4 * 512
    runner = GenoRunner(index, GenoConfig(**BASE), device="cpu")
    runner.consume_fastq(FQ, checkpoint_path=ck)
    out = str(tmp_path / "resumed.vcf")
    runner.write_vcf(VCF, out)
    assert open(out).read() == GOLDEN


def test_jax_checkpoint_resumes_on_two_processes(prefix, tmp_path,
                                                 jax_runs):
    ck = str(tmp_path / "ck")
    for ext in (".npz", ".json"):
        shutil.copy(jax_runs[0] + ext, ck + ext)
    assert _cluster(prefix, tmp_path, ("--checkpoint", ck)) == GOLDEN
    assert ckpt.load(ck)[2]["n_reads"] == 20443


A2A_WORKER = """
import sys
import numpy as np, torch
from vargeno_tpu_torch.dist import multihost
port, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
cluster = multihost.initialize(f"tcp://localhost:{port}", 2, rank, "gloo",
                               timeout=60)
mesh = multihost.ProcessMesh(cluster, ["cpu", "cpu"])
bufs = np.random.default_rng(7).integers(-2**40, 2**40, (3, 4, 4, 5, 2))
def shard(r):
    return [mesh.all_to_all(r, torch.from_numpy(bufs[k, r]))
            for k in range(3)]
got = mesh.run_lockstep([lambda r=r: shard(r) for r in
                         range(mesh.offset, mesh.offset + 2)])
np.save(out, np.stack([np.stack([t.numpy() for t in g]) for g in got]))
multihost.shutdown(cluster)
"""


def test_process_all_to_all_matches_single_process_mesh(tmp_path):
    """P = 2 processes x 2 local shards exchange exactly what the
    single-process mesh of D = 4 exchanges, three rounds in a row, on
    buffers from one numpy seed."""
    port = _free_port()
    outs = [str(tmp_path / f"a2a{p}.npy") for p in range(2)]
    rcs, logs = _spawn([[sys.executable, "-c", A2A_WORKER, str(port),
                         str(p), outs[p]] for p in range(2)])
    assert rcs == [0, 0], "\n".join(logs)
    bufs = np.random.default_rng(7).integers(-2**40, 2**40, (3, 4, 4, 5, 2))
    mesh = make_mesh(devices=["cpu"] * 4, timeout=60)

    def shard(r):
        return [mesh.all_to_all(r, torch.from_numpy(bufs[k, r])).numpy()
                for k in range(3)]
    want = mesh.run_lockstep([lambda r=r: shard(r) for r in range(4)])
    got = np.concatenate([np.load(o) for o in outs])   # (4 shards, 3, ...)
    assert got.shape == (4, 3, 4, 5, 2)
    for r in range(4):
        np.testing.assert_array_equal(got[r], np.stack(want[r]))


def test_failed_peer_ends_the_cluster(prefix, tmp_path):
    """Process 1 raises before its first collective (its index does not
    exist); process 0 must exit non-zero well within the time limit, not
    wait on it."""
    port = _free_port()
    rcs, outs = _spawn([
        _geno(prefix, str(tmp_path / "a.vcf"), port, 0, mesh=2),
        _geno(str(tmp_path / "missing"), str(tmp_path / "b.vcf"), port, 1,
              mesh=2)], timeout=90)
    assert rcs[1] != 0 and rcs[0] != 0, outs[0][-2000:]
    assert not os.path.exists(tmp_path / "a.vcf")


@pytest.mark.parametrize("skip", [0, 100])
def test_strided_reader_matches_jax(tmp_path, skip):
    """Each of P = 4 stripes (LB = 16) yields exactly what the JAX reader's
    does: codes, n_kmers, qual, n_valid and global_n_valid, batch by
    batch; and the stripes together partition the file. The file is the
    fixture's first 1,000 reads (both readers rescan their buffer at each
    skip, so the whole fixture takes seconds a stripe), which leave a
    part-filled last global batch."""
    fq = head_fastq(FQ, str(tmp_path / "head.fq"), 1000)
    got = [list(fastq.iter_read_batches_strided(fq, 16, 4, p, 128, 4,
                                                skip_reads=skip))
           for p in range(4)]
    for p in range(4):
        want = list(j_fastq.iter_read_batches_strided(fq, 16, 4, p, 128, 4,
                                                      skip_reads=skip))
        assert len(got[p]) == len(want) > 0
        for b, w in zip(got[p], want):
            np.testing.assert_array_equal(b.codes, w.codes)
            np.testing.assert_array_equal(b.n_kmers, w.n_kmers)
            np.testing.assert_array_equal(b.qual, w.qual)
            assert (b.n_valid, b.global_n_valid) == (w.n_valid,
                                                     w.global_n_valid)
    assert sum(b.global_n_valid for b in got[0]) == 1000 - skip
    assert sum(b.n_valid for g in got for b in g) == 1000 - skip
    assert got[0][-1].global_n_valid < 64


def test_cli_multihost_refusals(prefix, tmp_path, capsys):
    """Layouts that cannot run are refused before any process group is
    joined."""
    args = ["geno", prefix, FQ, VCF, str(tmp_path / "o.vcf"), "--device",
            "cpu"]
    mh = ["--multihost", "localhost:1", "--num-processes", "2"]
    for extra, msg in (
            (["--process-id", "1"], "need --multihost"),
            (mh + ["--process-id", "2"], "outside 0 .. 1"),
            (mh + ["--mesh", "3"], "not divisible by 2"),
            (mh + ["--mesh", "4", "--local-devices", "cpu"],
             "1 --local-devices named for 2"),
            (mh + ["--local-devices", "cuda:0"], "must be cpu devices"),
            (mh + ["--dist-backend", "nccl"], "nccl needs --device cuda")):
        assert cli.main(args + extra) == 1, extra
        assert msg in capsys.readouterr().err, extra
    assert not os.path.exists(tmp_path / "o.vcf")


KILL_WORKER = """
import sys, time
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.dist import multihost
from vargeno_tpu_torch.index import store
port, rank, P, L, prefix, out, ck, pace = sys.argv[1:9]
cluster = multihost.initialize(f"tcp://localhost:{port}", int(P), int(rank),
                               "gloo", timeout=60)
mesh = multihost.ProcessMesh(cluster, ["cpu"] * int(L))
runner = multihost.MultiHostGenoRunner(store.load(prefix), mesh,
                                       GenoConfig(batch_reads=256,
                                                  max_read_len=128,
                                                  max_kmers_per_read=4))
dispatch = runner._dispatch
def paced(*a, **k):   # a leg to be killed leaves the killer time
    time.sleep(float(pace))
    return dispatch(*a, **k)
runner._dispatch = paced
runner.consume_fastq(FQ, checkpoint_path=ck or None, checkpoint_every=2)
runner.write_vcf(VCF, out)
multihost.shutdown(cluster)
"""


@pytest.mark.parametrize("P,L", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_cluster_killed_after_a_checkpoint_resumes_byte_identical(
        prefix, tmp_path, P, L):
    """Kill / resume across processes: a cluster of P processes x L
    shards (2 x 2, and 4 x 1: a process a card on four cards)
    checkpointing every 2 global batches is SIGKILLed, every rank, once a
    checkpoint past half the reads is on disk; the same cluster run again
    resumes from it. Its VCF is byte-identical to an uninterrupted
    cluster's and to golden."""
    from vargeno_tpu_torch.tools.endurance_wgs import (checkpoint_offset,
                                                        kill_past)

    code = KILL_WORKER.replace("FQ", repr(FQ)).replace("VCF", repr(VCF))
    ck = str(tmp_path / "ck")

    def leg(out, check, pace=0.0, kill=None):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(port), str(r), str(P), str(L),
             prefix, str(tmp_path / out), check, str(pace)], cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(P)]
        try:
            killed_at = kill_past(procs, kill)
            outs = [p.communicate(timeout=CLUSTER_TIMEOUT)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [p.returncode for p in procs], outs, killed_at

    rcs, outs, _ = leg("full.vcf", "")
    assert rcs == [0] * P, "\n".join(o[-3000:] for o in outs)
    full = open(tmp_path / "full.vcf").read()
    assert full == GOLDEN
    half, total = 20443 // 2, 20443
    rcs, outs, killed_at = leg("resumed.vcf", ck, pace=0.05,
                               kill=(ck, half, total))
    assert rcs == [-9] * P and killed_at is not None, outs
    assert not os.path.exists(tmp_path / "resumed.vcf")
    assert half <= checkpoint_offset(ck) < total
    assert checkpoint_offset(ck) % 1024 == 0   # whole global batches
    rcs, outs, _ = leg("resumed.vcf", ck)
    assert rcs == [0] * P, "\n".join(o[-3000:] for o in outs)
    assert open(tmp_path / "resumed.vcf").read() == full
    assert checkpoint_offset(ck) == total


@pytest.mark.parametrize("P,local_D,n,want", [
    (4, 1, 4, [["cuda:0"], ["cuda:1"], ["cuda:2"], ["cuda:3"]]),
    (2, 2, 4, [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]),
    (2, 4, 4, [["cuda:0", "cuda:1", "cuda:2", "cuda:3"]] * 2),
    (8, 1, 4, [[f"cuda:{p % 4}"] for p in range(8)]),
    (2, 1, 1, [["cuda:0"], ["cuda:0"]]),
])
def test_cli_default_cards_of_each_process(monkeypatch, P, local_D, n,
                                           want):
    """Without --local-devices, the processes of one host share its n
    cards out in process-id order (a process alone on its host, or each
    host's first, starts at cuda:0); nccl is the default backend."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    for pid in range(P):
        args = argparse.Namespace(
            multihost="localhost:1", num_processes=P, process_id=pid,
            device="cuda", local_devices=None, mesh=P * local_D,
            dist_backend=None)
        assert cli._process_layout(args) == (want[pid], "nccl"), pid


def test_cli_default_cards_refused_when_short(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    args = argparse.Namespace(
        multihost="localhost:1", num_processes=2, process_id=1,
        device="cuda", local_devices=None, mesh=4, dist_backend=None)
    with pytest.raises(ValueError, match="takes cards 2 .. 3 but 3 CUDA"):
        cli._process_layout(args)
