"""The port's differential fuzzer (``vargeno_tpu_torch/tools/fuzz_diff.py``)
on the CPU: its draw against the JAX tool's (``tools/fuzz_diff.py``, loaded
by path, its fixture and runner replaced by stubs that record their
arguments), seeds through GenoRunner, the mesh and the sharded dictionary
against the port's oracle, one seed's counts against the JAX GenoRunner's,
and the command line."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_index_share import jax_view

import vargeno_tpu.engine.geno as j_geno
import vargeno_tpu.testing as j_testing
from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
from vargeno_tpu_torch.dist.sharding import ShardedGenoRunner
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.tools import fuzz_diff

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stop(Exception):
    pass


def _jax_draw(seed, monkeypatch):
    """What the JAX tool's ``run_seed(seed)`` hands to ``make_synthetic``
    and to ``GenoRunner``, without building or running either."""
    monkeypatch.setattr(sys, "path", list(sys.path))   # the tool inserts
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")         # the tool sets it
    spec = importlib.util.spec_from_file_location(
        "_jax_fuzz_diff", os.path.join(ROOT, "tools", "fuzz_diff.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    seen = {}

    def make_synthetic(**kw):
        seen["synth"] = kw
        return "index", "fa", "vcf", "fq"

    def runner(index, cfg, queued_orientation=True):
        seen["config"], seen["queued"] = cfg, queued_orientation
        raise _Stop

    monkeypatch.setattr(j_testing, "make_synthetic", make_synthetic)
    monkeypatch.setattr(j_geno, "GenoRunner", runner)
    with pytest.raises(_Stop):
        tool.run_seed(seed)
    return seen


@pytest.mark.parametrize("seed,big", [(s, False) for s in range(20)]
                         + [(0, True)])
def test_draw_matches_jax_tool(seed, big, monkeypatch):
    monkeypatch.setenv("VGT_FUZZ_BIG", "1" if big else "0")
    want = _jax_draw(seed, monkeypatch)
    case = fuzz_diff.draw_case(seed)
    assert want["synth"] == dict(seed=seed, **case["synth"])
    for k, v in {**case["config"], **case["dropped"]}.items():
        assert getattr(want["config"], k) == v, k
    assert want["queued"] == case["queued"]
    if big:   # the big seed's case, as the smoke run's docs state it
        assert case["synth"]["sizes"] == (317_860, 167_250)
        assert (case["synth"]["n_snps"], case["synth"]["n_reads"],
                case["synth"]["err_frac"], case["config"]["batch_reads"],
                case["queued"]) == (4_500, 307_000, 0.1, 64, False)


@pytest.mark.parametrize("seed", range(4))
def test_seed_passes_through_geno_runner(seed, tmp_path):
    got = fuzz_diff.run_seed(seed, "cpu", tmpdir=str(tmp_path))
    assert got["ok"] and got["mismatches"] == 0, got
    assert not got["overflow"], got
    assert got["reads"] == fuzz_diff.draw_case(seed)["synth"]["n_reads"]


@pytest.mark.parametrize("seed,cls", [(0, ShardedGenoRunner),
                                      (2, ShardedDictGenoRunner)],
                         ids=["mesh-D2", "sharded-dict-D2"])
def test_seed_passes_through_mesh_runners(seed, cls, tmp_path):
    """Seed 0 is two chromosomes, the inline dual step at B = 64; seed 2
    starts at E = 16 and escalates."""
    got = fuzz_diff.run_seed(seed, "cpu", fuzz_diff.mesh_runner(cls, 2),
                             tmpdir=str(tmp_path))
    assert got["ok"] and not got["overflow"], got


def test_seed_counts_equal_jax_runner(tmp_path):
    """Seed 1 (B = 509, queued, escalates once): the port's counts equal the
    JAX GenoRunner's, unsaturated, on the same fixture and the JAX tool's
    whole config (its dropped fields included)."""
    prep = fuzz_diff.prepare(1, str(tmp_path))
    case = prep.case
    port = GenoRunner(prep.index, GenoConfig(**case["config"]),
                      device="cpu", queued_orientation=case["queued"])
    port.consume_fastq(prep.fq)
    j = j_geno.GenoRunner(jax_view(prep.index),
                          JConfig(**case["config"], **case["dropped"]),
                          queued_orientation=case["queued"])
    j.consume_fastq(prep.fq)
    n = prep.index.sites.pos.shape[0]
    rc, ac = port.host_counts()
    np.testing.assert_array_equal(rc[:n], np.asarray(j.ref_cnt)[:n])
    np.testing.assert_array_equal(ac[:n], np.asarray(j.alt_cnt)[:n])
    assert port.n_escalations > 0 and rc[:n].sum() > 0


@pytest.mark.parametrize("args,rc,want", [
    (["4", "0", "--device", "cpu"], 0, "4/4 passed"),
    ([], 1, "error: no CUDA device is available"),
], ids=["cpu", "no-card"])
def test_command_line(args, rc, want):
    """Four seeds pass on the host when it is asked for; with no card and
    no --device the tool stops with an error (it never runs on the host
    unasked)."""
    code = ("import runpy, sys, torch; "
            "torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['fuzz_diff'] + {args!r}; "
            "runpy.run_module('vargeno_tpu_torch.tools.fuzz_diff', "
            "run_name='__main__')")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == rc, r.stdout + r.stderr
    assert want in r.stdout + r.stderr
    if rc == 0:
        assert r.stdout.count(": PASS") == 4
    else:
        assert "seed" not in r.stdout


def test_bad_sites_flags_a_changed_count(tmp_path):
    """A count off by one at one site is one bad site; counts above the
    oracle's saturation at 63 agree with its 63."""
    prep = fuzz_diff.prepare(15, str(tmp_path))
    rc = np.append(prep.orc_ref, 0).astype(np.int32)
    ac = np.append(prep.orc_alt, 0).astype(np.int32)
    assert fuzz_diff.bad_sites(prep, rc, ac) == []
    i = int(np.argmax(prep.orc_ref))
    rc[i] += 1
    assert len(fuzz_diff.bad_sites(prep, rc, ac)) == (
        0 if prep.orc_ref[i] >= 63 else 1)
    rc[i] = 100
    prep.orc_ref[i] = 63
    assert fuzz_diff.bad_sites(prep, rc, ac) == []
    ac[0] += 1
    bad = fuzz_diff.bad_sites(prep, rc, ac)
    assert len(bad) == 1 and bad[0].startswith("  site 0 ")
