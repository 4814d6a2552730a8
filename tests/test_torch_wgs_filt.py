"""Phase ``wgs_filt`` of ``chip_smoke.py`` (``--wgs --filt``: index, filt
and geno at the whole genome's scale on one card) rehearsed on the CPU at
1 Mb: the phase's own code on the host.

The genome is the rehearsal tool's 1 Mb draw at the whole genome's SNP
density (1,667 SNPs, 2,048 reads), its index built here with a small Bloom
geometry, B = 512. (a) and (b) run the rehearsal tool's command line
(``--phase index --filt``): the index is there, so it runs ``filt``
through the CLI in a process of its own; (c) places the filtered index at
D = 1 in this process; (d) runs ``geno`` through the CLI in
``--cli-rank``, which calls ``cli_rank`` directly here (``main`` refuses
to run without a card) and counts the plain vote's calls as launches (on
the host the wrapper runs the plain vote). The bare vote launch that (c)
times on the card is a check of its records here. (c)'s counts are held
against the port's sequential oracle on the filtered index (the spot
parity, over every site), and (d)'s VCF against (c)'s; the JAX runner on
the JAX filt's index is held against the port's in
tests/test_torch_filt_stream.py."""

import json
import os
import sys

import pytest
import torch

from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.index.build import build_index
from vargeno_tpu_torch.kernels import vote
from vargeno_tpu_torch.tools import rehearse_wgs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

MB, SNPS, READS, BATCH, SPOT = 1, 1667, 2048, 512, 256

WORKER = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
import chip_smoke
from vargeno_tpu_torch.kernels import vote
plain = vote.vote_scan_records_plain
def counted(*a):
    vote.vote_scan_records.launches += 1
    return plain(*a)
vote.vote_scan_records_plain = counted
for name, value in json.loads(sys.argv[3]).items():
    setattr(chip_smoke, name, value)
sys.exit(chip_smoke.cli_rank(json.loads(sys.argv[2])))
"""

CONSTANTS = dict(DEVICE="cpu", WGS3_FILT_DEVICES="cpu", BATCH=BATCH,
                 WGS3_MB=MB, WGS3_SNPS=SNPS, WGS_READS=READS, WGS_SPOT=SPOT,
                 WGS3_DUP_SHARE=0.0, WGS3_FILT_DISK=1e8, WGS3_IO_DISK=1e8,
                 WGS3_INDEX_DISK=1e8)


@pytest.fixture(scope="module")
def wgs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("wgs_filt"))
    fa, vcf, _ = rehearse_wgs.gen_inputs(d, MB, SNPS, READS)
    build_index(fa, vcf, os.path.join(d, "wgs"), config=GenoConfig(
        ref_bf_bytes=1 << 21, ref_lite_bf_bytes=8, snp_bf_bytes=1 << 17))
    return d


def test_phase_wgs_filt_on_the_host(wgs, monkeypatch, tmp_path):
    """(b) filt through the CLI keeps about a quarter of the ref rows,
    into the directory that ``<dir>/wgs_filt.vgt`` links to, whose stale
    index the phase clears first; (c) D = 1: no overflow, the vote
    launched, retry batches, 0 oracle mismatches over every site; (d) the
    CLI's VCF byte-identical to (c)'s, the vote launched; every stage's
    peak RSS under MemTotal."""
    behind = tmp_path / "filt_elsewhere"
    (behind / "derived_torch").mkdir(parents=True)
    for name in ("meta.json", "stale.npy", "derived_torch/stale"):
        (behind / name).write_text("{}")
    os.symlink(behind, os.path.join(wgs, "wgs_filt.vgt"))
    for name, value in CONSTANTS.items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "wgs_dir", lambda: wgs)
    monkeypatch.setattr(chip_smoke, "worker_command", lambda flag, spec: [
        sys.executable, "-c", WORKER.format(root=ROOT), flag,
        json.dumps(spec), json.dumps(CONSTANTS)])
    plain = vote.vote_scan_records_plain

    def counted(*a):
        vote.vote_scan_records.launches += 1
        return plain(*a)
    monkeypatch.setattr(vote, "vote_scan_records_plain", counted)
    monkeypatch.setattr(vote.vote_scan_records, "launches", 0, raising=False)

    def vote_on_step(phase, card, records, C):
        process, target, _ = plain(*records, C)
        assert process.shape == target.shape == (records[0].shape[0],)
        return dict(shape=tuple(records[0].shape) + (C,))
    monkeypatch.setattr(chip_smoke, "time_vote_on_step", vote_on_step)

    out = chip_smoke.phase_wgs_filt("cpu")
    fl, c, d = out["filt"], out["sharded"], out["cli"]
    assert 0.2 < fl["kept_share"] < 0.3 and fl["disk_bytes"] > 0
    assert out["ref_rows"] == fl["kept_rows"] < fl["ref_rows"]
    assert c["shards"] == 1 and c["reads"] == READS and c["retry_batches"]
    assert c["vote_launches"] > 0 and c["spot"]["mismatches"] == 0
    assert c["spot"]["sites"] == SNPS and c["spot"]["reads"] == SPOT
    assert d["vcf_equal"] and d["vote_launches"] > 0 and not d["overflow"]
    assert out["vote_on_step"]["shape"][0] == BATCH
    assert len(out["stage_peak_rss"]) > 8 and all(
        v < out["host"]["mem_total"]
        for v in out["stage_peak_rss"].values())
    assert store.exists(os.path.join(wgs, "wgs_filt"))
    assert os.path.islink(os.path.join(wgs, "wgs_filt.vgt"))
    assert not (behind / "stale.npy").exists()
    assert not (behind / "derived_torch" / "stale").exists()
    assert fl["rss_before"] <= fl["peak_rss"]


def test_rehearsal_redoes_a_filt_older_than_its_index(tmp_path):
    """``rehearse_wgs --filt`` keeps a filtered index only if it was
    written after the index it filters (each meta.json, written last)."""
    src, out = str(tmp_path / "wgs"), str(tmp_path / "wgs_filt")
    assert not rehearse_wgs.filt_is_current(src, out)
    for p, t in ((src, 100), (out, 200)):
        os.makedirs(p + ".vgt")
        with open(os.path.join(p + ".vgt", "meta.json"), "w") as f:
            f.write("{}")
        os.utime(os.path.join(p + ".vgt", "meta.json"), (t, t))
    assert rehearse_wgs.filt_is_current(src, out)
    os.utime(os.path.join(src + ".vgt", "meta.json"), (300, 300))
    assert not rehearse_wgs.filt_is_current(src, out)
