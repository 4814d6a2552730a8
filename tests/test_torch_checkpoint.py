"""The port's checkpoint (``engine/checkpoint.py``) as one atomic record:
the meta (the read offset) is saved inside ``<path>.npz`` beside the
counts, so the single replace of the npz commits both. A save torn between
its two replaces (the npz's and then the JSON's) resumes to the
uninterrupted run's counts, in one process and in a 2-process cluster over
gloo; the port and the JAX package read each other's checkpoints."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_index_share import FIX, small_index

from vargeno_tpu.engine import checkpoint as j_ckpt
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.engine import checkpoint as ckpt
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.tools.endurance_wgs import checkpoint_offset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FQ = os.path.join(FIX, "reads.fq")
VCF = os.path.join(FIX, "snps.vcf")
GOLDEN = open(os.path.join(FIX, "golden_output.vcf")).read()
CFG = GenoConfig(batch_reads=512, max_read_len=128, max_kmers_per_read=4)


@pytest.fixture(scope="module")
def index():
    return small_index()


@pytest.fixture(scope="module")
def full_counts(index):
    r = GenoRunner(index, CFG, device="cpu")
    r.consume_fastq(FQ)
    return r.host_counts()


class _Crash(Exception):
    pass


def _tear_second_save(monkeypatch):
    """Make the JSON replace of the second save raise, after its npz has
    been replaced: a process killed between the two replaces."""
    replace = os.replace
    seen = []

    def torn(src, dst):
        if dst.endswith(".json"):
            seen.append(dst)
            if len(seen) == 2:
                raise _Crash(dst)
        return replace(src, dst)
    monkeypatch.setattr(os, "replace", torn)


@pytest.mark.parametrize("queued", [True, False],
                         ids=["queued", "inline-dual"])
def test_torn_save_resumes_to_uninterrupted_counts(index, full_counts,
                                                   tmp_path, monkeypatch,
                                                   queued):
    ck = str(tmp_path / "ck")
    _tear_second_save(monkeypatch)
    first = GenoRunner(index, CFG, device="cpu", queued_orientation=queued)
    with pytest.raises(_Crash):
        first.consume_fastq(FQ, checkpoint_path=ck, checkpoint_every=4)
    monkeypatch.undo()
    # the torn pair: new counts and offset in the npz, the old JSON
    with open(ck + ".json") as f:
        stale = json.load(f)["n_reads"]
    assert 0 < stale < ckpt.read_meta(ck)["n_reads"] == first.n_reads
    second = GenoRunner(index, CFG, device="cpu", queued_orientation=queued)
    second.consume_fastq(FQ, checkpoint_path=ck)
    assert second.n_reads == 20443
    for got, want in zip(second.host_counts(), full_counts):
        np.testing.assert_array_equal(got, want)


def test_port_load_reads_jax_checkpoint(tmp_path):
    """A JAX checkpoint has no meta entry: the offset comes from its
    JSON."""
    ck = str(tmp_path / "jax")
    rc = np.arange(7, dtype=np.int32)
    j_ckpt.save(ck, rc, 2 * rc, 1234, {"note": "jax"})
    got_rc, got_ac, meta = ckpt.load(ck)
    np.testing.assert_array_equal(got_rc, rc)
    np.testing.assert_array_equal(got_ac, 2 * rc)
    assert meta == {"n_reads": 1234, "note": "jax"}
    assert ckpt.read_meta(ck) == meta


def test_jax_load_reads_port_checkpoint(tmp_path):
    ck = str(tmp_path / "port")
    rc = np.arange(5, dtype=np.int32)
    ckpt.save(ck, rc, rc + 1, 99, {"note": "port"})
    with np.load(ck + ".npz", allow_pickle=False) as z:   # no pickle
        assert z["meta"].dtype.kind == "U"
    got_rc, got_ac, meta = j_ckpt.load(ck)
    np.testing.assert_array_equal(got_rc, rc)
    np.testing.assert_array_equal(got_ac, rc + 1)
    assert meta == {"n_reads": 99, "note": "port"} == ckpt.load(ck)[2]


def test_offset_is_read_from_the_npz(tmp_path):
    """The endurance tool's kill poll and a resume read the same offset:
    the npz's, whatever the JSON beside it says (stale or missing)."""
    ck = str(tmp_path / "ck")
    assert checkpoint_offset(ck) is None and ckpt.load(ck) is None
    ckpt.save(ck, np.zeros(3, np.int32), np.zeros(3, np.int32), 512)
    ckpt.save(ck, np.ones(3, np.int32), np.ones(3, np.int32), 1024)
    with open(ck + ".json", "w") as f:
        f.write('{"n_reads": 512}')
    assert checkpoint_offset(ck) == 1024 == ckpt.load(ck)[2]["n_reads"]
    os.remove(ck + ".json")
    assert checkpoint_offset(ck) == 1024
    np.testing.assert_array_equal(ckpt.load(ck)[0], np.ones(3))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cluster(prefix, out, extra):
    """A 2 process x 1 shard geno run over gloo on the mini reads."""
    port = _free_port()
    cmds = [[sys.executable, "-m", "vargeno_tpu_torch.cli", "geno", prefix,
             FQ, VCF, out if pid == 0 else out + ".ignored", "--device",
             "cpu", "--batch-reads", "512", "--mesh", "2", "--multihost",
             f"localhost:{port}", "--num-processes", "2", "--process-id",
             str(pid), *extra] for pid in (0, 1)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        o[-3000:] for o in outs)


def test_two_processes_resume_a_torn_checkpoint(index, tmp_path):
    """Process 0 of a 2-process cluster saves the merged counts with their
    offset in the npz; with the JSON beside it left stale (a kill between
    the two replaces), the cluster resumes byte-identical to golden."""
    prefix = str(tmp_path / "mini")
    store.save(prefix, index)
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out.vcf")
    _cluster(prefix, out, ("--checkpoint", ck, "--limit-batches", "3"))
    assert ckpt.read_meta(ck)["n_reads"] == 3 * 2 * 512
    with open(ck + ".json", "w") as f:
        f.write('{"n_reads": 0}')
    _cluster(prefix, out, ("--checkpoint", ck))
    assert open(out).read() == GOLDEN
    assert ckpt.read_meta(ck)["n_reads"] == 20443
