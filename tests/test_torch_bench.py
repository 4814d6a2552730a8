"""The port's measurement entry points (``vargeno_tpu_torch/tools``: bench,
bench_cohort, bench_index_build) and the CLI pieces they brought, on the
CPU at a tiny
workload (0.2 Mb, 2,000 SNPs, 4,096 reads, batch 512). Counts are held
exactly against the JAX package's runners on the same files and index
(``jax_view``), and index files byte for byte against the JAX CLI's."""

import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch_index_share import FIX, bench_cache, jax_view, small_index

from vargeno_tpu import cli as j_cli
from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.engine.cohort import CohortRunner as JCohort
from vargeno_tpu.engine.geno import GenoRunner as JRunner
from vargeno_tpu.index import build as j_build
from vargeno_tpu_torch import cli
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.engine.device_index import build_device_index
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.index import build as t_build
from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.tools import bench, bench_cohort, bench_index_build
from vargeno_tpu_torch.tools.bench_gather import bench as gather_bench

torch.set_num_threads(2)

LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "passes_clean",
             "passes_total", "pass_spread", "device_rate", "retry_frac",
             "index_build_s", "index_build_vs", "lane_roofline_frac",
             "bw_roofline_frac", "device", "vote_launches", "mode",
             "group_size", "pipeline_depth"}
SMALL_BLOOM = dict(ref_bf_bytes=1 << 21, ref_lite_bf_bytes=1 << 21,
                   snp_bf_bytes=1 << 18)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The tiny workload's cache (dataset, small-Bloom index, the host's
    gather rates under the full-size key names the roofline reads) and the
    environment that names it."""
    cache = str(tmp_path_factory.mktemp("bench"))
    env = bench_cache(cache)
    rates = gather_bench("cpu", table_mb=4, shrink=64, reps=2, verbose=False)
    n = (1 << 20) // 64
    rates["word_gather_1048576"] = rates[f"word_gather_{n}"]
    rates["row_gather_1048576"] = rates[f"row_gather_{n}"]
    with open(os.path.join(cache, "gather_rates.json"), "w") as f:
        json.dump(rates, f)
    return env


@pytest.fixture
def wl(ws, monkeypatch):
    for k, v in ws.items():
        monkeypatch.setenv(k, v)
    return bench.Workload.from_env()


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _jax_counts(runner):
    return np.asarray(runner.ref_cnt), np.asarray(runner.alt_cnt)


def _jax_config(cfg):
    """The JAX package's config of the same field values (the port's own
    ``amb_hits_per_read`` has no JAX field)."""
    jax_fields = {f.name for f in dataclasses.fields(JConfig)}
    return JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(GenoConfig)
                      if f.name in jax_fields})


def test_bench_line_and_counts_match_jax(wl, capsys):
    assert bench.main(["--device", "cpu"]) == 0
    line = _last_json(capsys.readouterr().out)
    assert set(line) == LINE_KEYS
    assert line["metric"] == "geno_throughput"
    assert line["unit"] == "reads/sec/cpu" and line["device"] == "cpu"
    assert line["passes_total"] >= 3 and line["value"] > 0
    assert 0 < line["lane_roofline_frac"] and 0 < line["bw_roofline_frac"]
    assert line["index_build_s"] is not None
    assert line["vote_launches"] == 0   # the host runs the plain vote
    got = np.load(wl.path("bench_counts.npz"))
    # the JAX runner on the same files, index and configuration
    jrun = JRunner(jax_view(store.load(wl.prefix)),
                   _jax_config(bench.bench_config(wl)))
    jrun.consume_fastq(wl.fq)
    assert not {k: v for k, v in jrun.stats_totals.items()
                if "overflow" in k and v}
    rc, ac = _jax_counts(jrun)
    np.testing.assert_array_equal(got["ref"], rc)
    np.testing.assert_array_equal(got["alt"], ac)
    assert int(got["ref"].sum() + got["alt"].sum()) > 0


def test_bench_fails_on_an_overflow_left(wl, monkeypatch):
    """Counts that may diverge from the reference are no measurement: with
    escalation off and a one-event cap, the bench raises."""
    orig = bench.bench_config
    monkeypatch.setattr(bench, "bench_config", lambda w: dataclasses.replace(
        orig(w), events_per_read=1, auto_retry_max=0))
    monkeypatch.setenv("VGT_BENCH_MODE", "queued")
    with pytest.raises(AssertionError, match="overflow counters left"):
        bench.run(wl, "cpu")


# --- pick_runner's calibration, on a fake timer ---

P = bench.Point
ALL = bench.points()


class _Fake:
    """Stand-in runners and timer: ``rates[point]`` is a list of the rates
    its passes read, in turn (10 once it is empty, and for a point not
    named); ``probe`` the device rate it reports."""

    def __init__(self, rates, probe=1000.0, fail=()):
        self.rates = {p: list(r) for p, r in rates.items()}
        self.probe_rate = probe
        self.fail = fail
        self.made = []
        self.probed = 0

    def make(self, point):
        if point in self.fail:
            raise RuntimeError(f"{point} failed to build")
        self.made.append(point)
        return point

    def time_pass(self, runner):
        rates = self.rates.get(runner)
        return rates.pop(0) if rates else 10

    def probe(self, runner):
        self.probed += 1
        return self.probe_rate


def _calibrate(fake, path, **kw):
    return bench.calibrate(fake.make, fake.time_pass, fake.probe, path,
                           "card|512|4096", **kw)


def _write(path, **cal):
    with open(path, "w") as f:
        json.dump(dict(key="card|512|4096", **cal), f)


def test_points_cover_the_jax_pairs_and_the_pins():
    pairs = [(p.group_size, p.pipeline_depth) for p in ALL
             if p.mode == "queued"]
    assert pairs == [(4, 2), (2, 2), (1, 2), (1, 3)]
    assert [p.mode for p in ALL].count("queued_tuned") == 4
    assert [p for p in ALL if p.mode == "inline_dual"] == [
        P("inline_dual", 1, 2)]
    assert bench.points("queued", 8, 3) == [P("queued", 8, 3)]
    assert bench.points(depth=1)[:3] == [P("queued", 4, 1),
                                         P("queued", 2, 1),
                                         P("queued", 1, 1)]
    assert all(p.mode != "inline_dual" for p in bench.points(group=4))
    with pytest.raises(ValueError, match="no dispatch point"):
        bench.points("inline_dual", 4)


def test_pins_from_the_environment(monkeypatch):
    for k in ("VGT_BENCH_MODE", "VGT_BENCH_GROUP", "VGT_BENCH_DEPTH"):
        monkeypatch.delenv(k, raising=False)
    assert bench.pinned_points() is None
    monkeypatch.setenv("VGT_BENCH_MODE", "queued")
    assert len(bench.pinned_points()) == 4
    monkeypatch.setenv("VGT_BENCH_GROUP", "2")
    monkeypatch.setenv("VGT_BENCH_DEPTH", "3")
    assert bench.pinned_points() == [P("queued", 2, 3)]


def test_calibrate_cache_miss_times_every_mode_and_caches(tmp_path):
    path = str(tmp_path / "calib.json")
    fake = _Fake({P("queued", 4, 2): [100], P("queued_tuned", 1, 3): [300],
                  P("inline_dual", 1, 2): [200]})
    pick = _calibrate(fake, path)
    want = P("queued_tuned", 1, 3)
    assert (pick.point, pick.mode, pick.rate, pick.runner) == (
        want, "queued_tuned", 300, want)
    assert fake.made == ALL
    cal = json.load(open(path))
    assert cal == dict(key="card|512|4096", mode="queued_tuned",
                       group_size=1, pipeline_depth=3, calib_rate=300,
                       device_rate=1000.0)


def test_calibrate_cache_hit_times_the_cached_mode_only(tmp_path):
    path = str(tmp_path / "calib.json")
    _write(path, mode="inline_dual", group_size=1, pipeline_depth=2,
           calib_rate=200, device_rate=1000)
    fake = _Fake({P("inline_dual"): [190]})
    assert _calibrate(fake, path).point == P("inline_dual")
    assert fake.made == [P("inline_dual")]
    # another key (card, batch or reads) is a miss
    fake = _Fake({P("queued", 4, 2): [100]})
    assert bench.calibrate(fake.make, fake.time_pass, fake.probe, path,
                           "other|512|4096").point == P("queued", 4, 2)
    assert fake.made == ALL


def test_calibrate_file_without_pipeline_knobs_recalibrates(tmp_path):
    """A calibration written before the knobs were calibrated names a
    mode only: it is no cache hit, and the new file has both knobs."""
    path = str(tmp_path / "calib.json")
    _write(path, mode="queued", calib_rate=200, device_rate=1000)
    fake = _Fake({P("queued", 2, 2): [500]})
    assert _calibrate(fake, path).point == P("queued", 2, 2)
    assert fake.made == ALL
    cal = json.load(open(path))
    assert (cal["group_size"], cal["pipeline_depth"]) == (2, 2)


def test_calibrate_rechecks_an_outlier(tmp_path):
    # a point reads 40 (< half of 100) once, then 150: re-timed, kept
    odd = P("queued_tuned", 2, 2)
    fake = _Fake({P("queued", 4, 2): [100], odd: [40, 150]})
    pick = _calibrate(fake, str(tmp_path / "calib.json"))
    assert (pick.point, pick.rate) == (odd, 150)
    assert fake.rates[odd] == []


def test_calibrate_device_probe_guard_keeps_the_cache(tmp_path):
    path = str(tmp_path / "calib.json")
    _write(path, mode="queued", group_size=1, pipeline_depth=2,
           calib_rate=1000, device_rate=5000)
    before = open(path).read()
    # the cached winner at 0.5 x its recorded rate, and the device probe at
    # 0.5 x its own: the card is shared, so no re-calibration
    fake = _Fake({P("queued"): [500]}, probe=2500)
    pick = _calibrate(fake, path)
    assert pick.point == P("queued") and fake.made == [P("queued")]
    assert open(path).read() == before


def test_calibrate_recalibrates_a_regressed_winner(tmp_path):
    path = str(tmp_path / "calib.json")
    _write(path, mode="queued", group_size=1, pipeline_depth=2,
           calib_rate=1000, device_rate=5000)
    # the probe reads as recorded: the choice is stale, not the card busy
    fake = _Fake({P("queued"): [500], P("queued_tuned", 4, 2): [800]},
                 probe=5000)
    pick = _calibrate(fake, path)
    assert pick.point == P("queued_tuned", 4, 2)
    assert fake.made == [P("queued")] + [p for p in ALL if p != P("queued")]
    assert json.load(open(path))["mode"] == "queued_tuned"


@pytest.mark.parametrize("forced", [None, [P("queued", 4, 2)]])
def test_calibrate_failing_mode_raises(tmp_path, forced):
    fake = _Fake({}, fail=(P("queued", 4, 2),))
    with pytest.raises(RuntimeError, match="queued G=4 depth=2 failed"):
        _calibrate(fake, str(tmp_path / "calib.json"), forced=forced)
    assert not os.path.exists(tmp_path / "calib.json")


@pytest.mark.parametrize("mode", bench.MODES)
def test_retry_frac_counts_the_reverse_passes(wl, mode):
    """The queued modes' measured retry fraction; 1 for inline dual, whose
    every read runs both orientations."""
    index = store.load(wl.prefix)
    cfg = bench.bench_config(wl)
    runner = bench.make_runner(index, build_device_index(
        index, "cpu", cfg.ht_target_load), wl, mode, "cpu")
    runner.consume_fastq(wl.fq)
    want = (runner.n_retry_reads / runner.n_reads
            if mode != "inline_dual" else 1.0)
    assert bench.retry_frac(runner) == want
    if mode != "inline_dual":
        assert 0.3 < want < 0.7   # about half the reads are reverse-strand
    rep = bench.roofline_report(runner, 1000.0, None)
    assert rep["lane_roofline_frac"] is None and rep["bw_roofline_frac"] > 0


def test_unknown_mode_raises(wl):
    with pytest.raises(ValueError, match="unknown dispatch mode"):
        bench.make_runner(None, None, wl, "no_pallas", "cpu")


def test_dataset_of_another_workload_is_refused(wl):
    other = dataclasses.replace(wl, reads=wl.reads + 1)
    with pytest.raises(ValueError, match="holds the dataset"):
        bench.build_dataset(other)


# --- bench_cohort ---

def test_cohort_donors_equal_one_pass_and_jax_cohort(wl, capsys):
    assert bench_cohort.main(["--device", "cpu", "--donors", "3"]) == 0
    line = _last_json(capsys.readouterr().out)
    assert set(line) == {"metric", "donors", "total_reads", "seconds",
                         "reads_per_sec", "donors_per_hour_at_6x_wgs",
                         "device", "vote_launches"}
    assert line["donors"] == 3 and line["total_reads"] == 3 * wl.reads
    got = np.load(wl.path("cohort_counts.npz"))
    index = store.load(wl.prefix)
    one = GenoRunner(index, bench.bench_config(wl), device="cpu")
    one.consume_fastq(wl.fq)
    rc, ac = one.host_counts()
    for d in ("d0", "d1", "d2"):
        np.testing.assert_array_equal(got[f"ref_{d}"], rc)
        np.testing.assert_array_equal(got[f"alt_{d}"], ac)
    c = bench.bench_config(wl)
    jc = JCohort(jax_view(index), ["a", "b"], JConfig(
        batch_reads=c.batch_reads, max_read_len=c.max_read_len,
        max_kmers_per_read=c.max_kmers_per_read, auto_tune=True,
        tune_batches=2))
    for name in ("a", "b"):
        jc.consume_sample(name, wl.fq)
        jrc, jac = (np.asarray(x) for x in jc.counts[name])
        np.testing.assert_array_equal(jrc, rc)
        np.testing.assert_array_equal(jac, ac)


# --- bench_index_build and the CLI's index / geno / genotype pieces ---

def _same_tree(a: str, b: str) -> None:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            while True:
                x, y = fa.read(1 << 24), fb.read(1 << 24)
                assert x == y, n
                if not x:
                    break


def test_index_build_tool_matches_jax_index(tmp_path, capsys):
    d = tmp_path / "ds"
    d.mkdir()
    for n in ("genome.fa", "snps.vcf"):
        shutil.copy(os.path.join(FIX, n), d / n)
    try:
        assert bench_index_build.main(["--dataset", str(d),
                                       "--reps", "1"]) == 0
        out = _last_json(capsys.readouterr().out)
        assert out["ours_s"] > 0 and len(out["ours_all_s"]) == 1
        assert out["ref_index_build_s"] == 104.26
        assert out["index_build_vs"] == round(104.26 / out["ours_s"], 2)
        assert bench_index_build.missing_artifacts(str(d / "ibench"),
                                                   False) == []
        # the JAX package's index of the same files, at the same (the
        # reference's) Bloom geometry
        j_build.build_index(str(d / "genome.fa"), str(d / "snps.vcf"),
                            str(d / "jax"))
        _same_tree(str(d / "ibench.vgt"), str(d / "jax.vgt"))
    finally:
        shutil.rmtree(d)


def test_index_build_tool_reports_missing_artifacts(tmp_path):
    p = str(tmp_path / "x")
    assert bench_index_build.missing_artifacts(p, True) == [
        ".vgt"] + list(bench_index_build.REFERENCE_FORMAT)
    os.makedirs(p + ".vgt")
    open(p + ".snp.bf", "w").close()
    assert ".snp.bf" not in bench_index_build.missing_artifacts(p, True)
    assert bench_index_build.missing_artifacts(p, False) == []


def test_cli_index_reference_format_matches_jax(tmp_path, monkeypatch):
    # both CLIs build at a small Bloom geometry (their build_index is
    # looked up when the command runs)
    monkeypatch.setattr(t_build, "build_index", functools.partial(
        t_build.build_index, config=GenoConfig(**SMALL_BLOOM)))
    monkeypatch.setattr(j_build, "build_index", functools.partial(
        j_build.build_index, config=JConfig(**SMALL_BLOOM)))
    fa, vcf = os.path.join(FIX, "genome.fa"), os.path.join(FIX, "snps.vcf")
    ours, theirs = str(tmp_path / "t"), str(tmp_path / "j")
    assert cli.main(["index", fa, vcf, ours, "--reference-format"]) == 0
    assert j_cli.main(["index", fa, vcf, theirs, "--reference-format"]) == 0
    for suf in bench_index_build.REFERENCE_FORMAT + (".chrlens",):
        assert open(ours + suf, "rb").read() == \
            open(theirs + suf, "rb").read(), suf
    # the reference binary's own dictionaries of this fixture
    for suf in (".ref.dict", ".snp.dict"):
        assert open(ours + suf, "rb").read() == open(
            os.path.join(FIX, "golden" + suf), "rb").read()
    assert store.exists(ours)
    # without the flag no reference-format file is written
    plain = str(tmp_path / "p")
    assert cli.main(["index", fa, vcf, plain]) == 0
    assert not any(os.path.exists(plain + s)
                   for s in bench_index_build.REFERENCE_FORMAT)


def test_cli_no_stride_bug_matches_jax(tmp_path):
    prefix = str(tmp_path / "idx")
    store.save(prefix, small_index())
    fq, vcf = os.path.join(FIX, "reads.fq"), os.path.join(FIX, "snps.vcf")
    outs = {}
    for tag, main, extra in (("t", cli.main, ["--device", "cpu"]),
                             ("j", j_cli.main, [])):
        for flag in ("--no-stride-bug", None):
            out = str(tmp_path / f"{tag}{bool(flag)}.vcf")
            assert main(["geno", prefix, fq, vcf, out, "--batch-reads",
                         "512"] + extra + ([flag] if flag else [])) == 0
            outs[tag, bool(flag)] = open(out).read()
    assert outs["t", True] == outs["j", True]
    assert outs["t", False] == outs["j", False] == open(
        os.path.join(FIX, "golden_output.vcf")).read()


def test_cli_genotype_is_a_noop_as_in_jax(capsys):
    assert cli.main(["genotype", "a", "b", "c"]) == 0
    ours = capsys.readouterr()
    assert j_cli.main(["genotype", "a", "b", "c"]) == 0
    theirs = capsys.readouterr()
    assert ours.err == theirs.err and "no-op" in ours.err
    assert ours.out == theirs.out == ""


def test_tools_refuse_cuda_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (bench, bench_cohort):
        assert tool.main([]) == 1
        assert "no CUDA device" in capsys.readouterr().err
