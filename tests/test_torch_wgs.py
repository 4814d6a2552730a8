"""The port's genome-scale tools (``vargeno_tpu_torch/tools/rehearse_wgs.py``
and ``endurance_wgs.py``) on the CPU, at 1 Mb / 5,000 SNPs / 2,048 reads:

- the synthesized inputs (FASTA, VCF, FASTQ, and the extra reads) are
  byte-identical to the JAX tool's (``tools/rehearse_wgs.py``, run in a
  subprocess so that its ``XLA_FLAGS`` edits stay out of this worker);
- on an index of those inputs at a small Bloom geometry, the hash-table
  and D = 1 sharded-dictionary runners give counts equal to the JAX
  ``ShardedDictGenoRunner`` at D = 1 (exact: integer counts), and the
  tool's ``geno`` phase on ``--device cpu`` writes the same VCF through
  either runner and passes its oracle spot parity;
- a checkpointed run stopped by ``--limit-batches`` and run again resumes
  to a VCF byte-identical to an uninterrupted run's, and the endurance
  tool's three legs (stand-in legs here) kill leg B at the checkpoint
  offset and fail when leg B ends first. The real SIGKILL of a streaming
  leg is the card's (``chip_smoke.py`` phase genome)."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch_index_share import jax_view

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.dist.sharded_dict import ShardedDictGenoRunner as JDict
from vargeno_tpu.dist.sharding import make_mesh as j_make_mesh
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.index.build import build_index
from vargeno_tpu_torch.tools import endurance_wgs, rehearse_wgs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB, SNPS, READS, EXTRA, BATCH = 1, 5000, 2048, 4096, 512
SIZE = ["--mb", str(MB), "--snps", str(SNPS), "--reads", str(READS)]
# small Bloom filters (2**24 ref bits, 2**20 snp bits): no 1.2 GB filter
SMALL_BLOOM = GenoConfig(ref_bf_bytes=1 << 21, ref_lite_bf_bytes=8,
                         snp_bf_bytes=1 << 17)
ENV = dict(os.environ, OMP_NUM_THREADS="2")


def _run(cmd, cwd=ROOT, timeout=300):
    r = subprocess.run(cmd, cwd=cwd, env=ENV, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def _tool(*args):
    """The port's rehearsal tool's command line in a fresh interpreter;
    returns its ``{"geno": ...}`` line (or None)."""
    out = _run([sys.executable, "-m", "vargeno_tpu_torch.tools.rehearse_wgs",
                *map(str, args)])
    lines = [json.loads(line)["geno"] for line in out.splitlines()
             if line.startswith('{"geno"')]
    return lines[-1] if lines else None


@pytest.fixture(scope="module")
def wgs(tmp_path_factory):
    """The port's inputs (and extra reads) and their small-Bloom index."""
    d = str(tmp_path_factory.mktemp("wgs"))
    fa, vcf, fq = rehearse_wgs.gen_inputs(d, MB, SNPS, READS)
    extra = rehearse_wgs.gen_extra_reads(d, fa, vcf, EXTRA)
    prefix = os.path.join(d, "wgs")
    build_index(fa, vcf, prefix, config=SMALL_BLOOM)
    return dict(cache=d, fa=fa, vcf=vcf, fq=fq, extra=extra,
                index=store.load(prefix))


@pytest.fixture(scope="module")
def port_vcf(wgs, tmp_path_factory):
    """The VCF of the port's hash-table runner run in this process with
    the tool's config."""
    r = rehearse_wgs.make_runner(wgs["index"],
                                 rehearse_wgs.geno_config(BATCH), "ht", "cpu")
    r.consume_fastq(wgs["fq"])
    out = str(tmp_path_factory.mktemp("port") / "out.vcf")
    r.write_vcf(wgs["vcf"], out)
    with open(out) as f:
        return f.read()


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_gen_inputs_match_jax_tool(wgs, tmp_path):
    _run([sys.executable, os.path.join(ROOT, "tools", "rehearse_wgs.py"),
          "--phase", "gen", *SIZE, "--cache", str(tmp_path)])
    for name in ("genome.fa", "snps.vcf", "reads.fq"):
        assert _bytes(tmp_path / name) == _bytes(
            os.path.join(wgs["cache"], name)), name


def test_gen_extra_reads_match_jax_tool(wgs, tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.argv = ["rehearse_wgs.py"]
        sys.path.insert(0, {os.path.join(ROOT, "tools")!r})
        import rehearse_wgs
        rehearse_wgs.gen_extra_reads({str(tmp_path)!r}, {wgs["fa"]!r},
                                     {wgs["vcf"]!r}, {EXTRA})
        """)
    _run([sys.executable, "-c", code])
    assert _bytes(tmp_path / f"reads_{EXTRA}.fq") == _bytes(wgs["extra"])


def test_runner_counts_match_jax_sharded_d1(wgs):
    """Both runners against the JAX sharded dictionary at D = 1, with the
    tool's config, in one test: the JAX step compiles once (about three
    minutes on a CPU host at this index size)."""
    cfg = rehearse_wgs.geno_config(BATCH)
    jrun = JDict(jax_view(wgs["index"]), j_make_mesh(1), JConfig(
        batch_reads=cfg.batch_reads, max_read_len=cfg.max_read_len,
        max_kmers_per_read=cfg.max_kmers_per_read,
        events_per_read=cfg.events_per_read))
    jrun.consume_fastq(wgs["fq"])
    j_rc, j_ac = jrun._host_counts()
    assert j_rc.sum() + j_ac.sum() > 0
    for runner in ("ht", "sharded"):
        r = rehearse_wgs.make_runner(wgs["index"], cfg, runner, "cpu")
        got = rehearse_wgs.stream(r, wgs["fq"], progress_every=0)
        assert got["reads"] == READS and got["resumed_from"] == 0
        assert not {k: v for k, v in got["stats"].items()
                    if "overflow" in k and v}
        rc, ac = r.host_counts()
        np.testing.assert_array_equal(rc, j_rc, err_msg=runner)
        np.testing.assert_array_equal(ac, j_ac, err_msg=runner)


@pytest.mark.parametrize("runner", ["ht", "sharded"])
def test_geno_phase_runners_agree_and_pass_spot_parity(wgs, port_vcf,
                                                       runner):
    out = f"out_{runner}.vcf"
    got = _tool("--phase", "geno", *SIZE, "--cache", wgs["cache"],
                "--device", "cpu", "--runner", runner, "--batch", BATCH,
                "--limit-batches", 0, "--spot-parity", 256, "--out", out,
                "--progress-every", 0)
    assert got["runner"] == runner and got["reads"] == READS
    assert got["spot"]["mismatches"] == 0 and got["spot"]["reads"] == 256
    assert got["spot"]["increments"] > 0 and not got["spot"]["overflow"]
    assert got["index_device_bytes"] > 0 and got["peak_device_bytes"] is None
    with open(os.path.join(wgs["cache"], out)) as f:
        assert f.read() == port_vcf


def test_checkpoint_stop_then_resume_is_byte_identical(wgs):
    common = ["--phase", "geno", *SIZE, "--cache", wgs["cache"], "--device",
              "cpu", "--batch", 256, "--extra-reads", EXTRA,
              "--checkpoint-every", 2, "--progress-every", 0]
    ck = os.path.join(wgs["cache"], "stop_ck")
    full = _tool(*common, "--limit-batches", 0, "--out", "full.vcf")
    assert full["reads"] == EXTRA
    stopped = _tool(*common, "--limit-batches", 5, "--checkpoint", ck,
                    "--out", "resumed.vcf")
    offset = endurance_wgs.checkpoint_offset(ck)
    assert 0 < offset == stopped["total_reads"] < EXTRA
    resumed = _tool(*common, "--limit-batches", 0, "--checkpoint", ck,
                    "--out", "resumed.vcf")
    assert resumed["resumed_from"] == offset
    assert resumed["reads"] == EXTRA - offset
    assert _bytes(os.path.join(wgs["cache"], "resumed.vcf")) == _bytes(
        os.path.join(wgs["cache"], "full.vcf"))


# a stand-in leg: A writes the VCF; B writes checkpoints at 256, 512 and
# 768 reads (the offset in the npz, as the port's checkpoint holds it, and
# in the JSON), then waits to be killed (or, when told to, ends at 256); C
# resumes from the checkpoint and writes the same VCF
FAKE_LEG = textwrap.dedent("""
    import json, os, sys, time
    import numpy as np
    cache, mode, extra = sys.argv[1], sys.argv[2], sys.argv[3:]
    out = os.path.join(cache, extra[extra.index("--out") + 1])

    def done(resumed_from):
        with open(out, "w") as f:
            f.write("#vcf\\n")
        print(json.dumps({"geno": {"resumed_from": resumed_from,
                                   "vote_launches": 1}}), flush=True)
        sys.exit(0)

    if "--checkpoint" not in extra:
        done(0)
    ck = extra[extra.index("--checkpoint") + 1]
    if os.path.exists(ck + ".json"):
        with open(ck + ".json") as f:
            done(json.load(f)["n_reads"])
    for off in (256,) if mode == "ends_first" else (256, 512, 768):
        np.savez(ck + ".tmp.npz", meta=np.array(json.dumps({"n_reads": off})))
        os.replace(ck + ".tmp.npz", ck + ".npz")
        with open(ck + ".json.tmp", "w") as f:
            json.dump({"n_reads": off}, f)
        os.replace(ck + ".json.tmp", ck + ".json")
        time.sleep(0.2)
    if mode == "ends_first":
        sys.exit(0)
    time.sleep(120)
    """)


@pytest.mark.parametrize("mode", ["killed", "ends_first"])
def test_endurance_legs_kill_at_the_checkpoint(tmp_path, monkeypatch,
                                               capsys, mode):
    fake = tmp_path / "leg.py"
    fake.write_text(FAKE_LEG)
    monkeypatch.setattr(endurance_wgs, "leg_command",
                        lambda args, extra: [sys.executable, str(fake),
                                             args.cache, mode, *extra])
    rc = endurance_wgs.main(["--cache", str(tmp_path), "--reads", "1024",
                             "--kill-after-frac", "0.5"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = last["endurance"]
    if mode == "ends_first":
        assert rc == 1 and not got["ok"]
        assert "before the kill point 512" in got["error"]
        assert not got["legs"]["B"]["killed"]
        return
    assert rc == 0 and got["ok"]
    assert got["legs"]["B"]["killed"] and got["legs"]["B"]["rc"] == -9
    assert got["killed_at_offset"] in (512, 768)
    assert got["legs"]["C"]["geno"]["resumed_from"] == got["killed_at_offset"]
