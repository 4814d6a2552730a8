"""Phase ``wgs_cards`` of ``chip_smoke.py`` (the whole genome with a shard
a card on four cards) rehearsed on the CPU at a small size: the phase's own
code, with four host ranks over gloo in place of four cards over nccl.

The genome is the rehearsal tool's 1 Mb draw (5,000 SNPs, 2,048 reads,
16,384 endurance reads) with a small Bloom geometry, B = 512. (b) runs the
sharded dictionary at D = 4 in this process (a thread a shard), (c) four
CLI processes of one host shard each (``--cli-rank``), (d) the
four-process kill / resume from ``--mh-worker`` specs, checkpointing every
global batch of 2,048 reads. The worker processes call ``mh_worker`` /
``cli_rank`` directly (``main`` refuses to run without a card), count the
plain vote's calls as launches (on the host the wrapper runs the plain
vote) and pace each batch by 0.1 s so that leg B's kill lands before its
stream ends. The synthesis and the build are done here, before the phase,
in place of the rehearsal tool's process. (b)'s VCF is held against the
JAX package's single-device runner on the same index, and so are (c)'s and
leg C's through their byte-equality with (b)'s and leg A's.

With ``--repeats`` the same phase runs on the tool's repeat-rich draw
(``--dup-share 0.3``) at 1 Mb, where B = 512 spills the ambiguous-exact
capacity: (b)'s first attempt must spill, every rank of (c) and of each
leg of (d) must escalate alike, and (b)'s counts are held against the JAX
package's sequential oracle (the JAX runner drops that spill unreported,
so it is no reference there). The bare vote launch that (b) times on the
card is a check of its records here (the plain vote on them)."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch_index_share import jax_view

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.engine.geno import GenoRunner as JRunner
from vargeno_tpu.oracle import OracleEngine as JOracle
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.index import store
from vargeno_tpu_torch.index.build import build_index
from vargeno_tpu_torch.kernels import vote
from vargeno_tpu_torch.tools import rehearse_wgs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

MB, SNPS, READS, EXTRA, BATCH, SPOT = 1, 5000, 2048, 16384, 512, 256
SMALL_BLOOM = GenoConfig(ref_bf_bytes=1 << 21, ref_lite_bf_bytes=8,
                         snp_bf_bytes=1 << 17)

WORKER = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
import chip_smoke
from vargeno_tpu_torch.dist.multihost import MultiHostDictGenoRunner
from vargeno_tpu_torch.kernels import vote
plain = vote.vote_scan_records_plain
def counted(*a):
    vote.vote_scan_records.launches += 1
    return plain(*a)
vote.vote_scan_records_plain = counted
dispatch = MultiHostDictGenoRunner._dispatch
def paced(self, *a, **k):
    time.sleep(0.1)
    return dispatch(self, *a, **k)
MultiHostDictGenoRunner._dispatch = paced
for name, value in json.loads(sys.argv[3]).items():
    setattr(chip_smoke, name, value)
flag, spec = sys.argv[1], json.loads(sys.argv[2])
sys.exit(chip_smoke.mh_worker(spec) if flag == "--mh-worker"
         else chip_smoke.cli_rank(spec))
"""

CONSTANTS = dict(DEVICE="cpu", WGS4_DEVICES="cpu,cpu,cpu,cpu",
                 WGS4_BACKEND="gloo", BATCH=BATCH, WGS3_MB=MB,
                 WGS3_SNPS=SNPS, WGS_READS=READS, WGS_EXTRA_READS=EXTRA,
                 WGS_SPOT=SPOT, WGS4_CHECKPOINT_EVERY=1, WGS3_DUP_SHARE=0.0)
DUP_SHARE = 0.3   # chip_smoke.REPEATS_DUP_SHARE, --repeats' share


def _inputs(d, dup_share=0.0):
    fa, vcf, _ = rehearse_wgs.gen_inputs(d, MB, SNPS, READS,
                                         dup_share=dup_share)
    rehearse_wgs.gen_extra_reads(d, fa, vcf, EXTRA)
    build_index(fa, vcf, os.path.join(d, "wgs"), config=SMALL_BLOOM)
    return d


@pytest.fixture(scope="module")
def wgs(tmp_path_factory):
    return _inputs(str(tmp_path_factory.mktemp("wgs_cards")))


@pytest.fixture(scope="module")
def wgs_repeats(tmp_path_factory):
    return _inputs(str(tmp_path_factory.mktemp("wgs_cards_repeats")),
                   DUP_SHARE)


def _run_phase(d, monkeypatch, dup_share=0.0):
    """Phase wgs_cards on the inputs and index in ``d``, four host ranks
    over gloo (``--repeats`` when ``dup_share`` is given). Returns (its
    result, every stage's peak RSS, (b)'s counts after its stream)."""
    constants = dict(CONSTANTS, WGS3_DUP_SHARE=dup_share)
    for name, value in constants.items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "wgs_dir", lambda: d)
    monkeypatch.setattr(chip_smoke, "worker_command", lambda flag, spec: [
        sys.executable, "-c", WORKER.format(root=ROOT), flag,
        json.dumps(spec), json.dumps(constants)])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    plain = vote.vote_scan_records_plain

    def counted(*a):
        vote.vote_scan_records.launches += 1
        return plain(*a)
    monkeypatch.setattr(vote, "vote_scan_records_plain", counted)
    monkeypatch.setattr(vote.vote_scan_records, "launches", 0, raising=False)

    def vote_on_step(phase, card, records, C):
        process, target, _ = plain(*records, C)
        assert process.shape == target.shape == (records[0].shape[0],)
        return dict(shape=tuple(records[0].shape) + (C,), raw_ms=None,
                    plain_ms=None, bound_ms=None)
    monkeypatch.setattr(chip_smoke, "time_vote_on_step", vote_on_step)
    counts = {}
    spot = rehearse_wgs.spot_parity

    def keep_counts(index, runner, fq, n_spot, **k):
        counts.setdefault("b", runner.host_counts())
        return spot(index, runner, fq, n_spot, **k)
    monkeypatch.setattr(rehearse_wgs, "spot_parity", keep_counts)

    setup = chip_smoke.wgs_setup("wgs_cards", "cpu", CONSTANTS["WGS4_DEVICES"])
    prep = chip_smoke.start_session([sys.executable, "-c", (
        "import json; print(json.dumps({'index': {'stage_peak_rss': "
        "{'build': 1}}}))")])
    stages: dict = {}
    out = chip_smoke.phase_wgs_cards("cpu", setup, prep, stages)
    return out, stages, counts["b"]


def _check_common(out, stages, sites=SNPS):
    """What every draw must show: (b)'s stream, spot parity over the
    index's ``sites`` and vote records; (c)'s VCF and ranks; (d)'s kill
    and resume; every stage's peak RSS under MemTotal."""
    b, c, d = out["b"], out["c"], out["d"]
    assert b["shards"] == 4 and b["reads"] == READS
    assert b["vote_launches"] > 0 and b["spot"]["mismatches"] == 0
    assert b["spot"]["sites"] == sites and b["spot"]["reads"] == SPOT
    assert b["route_overflow"] == 0
    assert b["vote_on_step"]["shape"][0] == BATCH
    assert c["vcf_equal"] and len(c["ranks"]) == 4
    assert all(r["vote_launches"] > 0 and not r["overflow"]
               for r in c["ranks"])
    assert EXTRA // 2 <= d["killed_at_offset"] < EXTRA
    assert all(r["resumed_from"] == d["killed_at_offset"]
               for r in d["legs"]["C"]["ranks"])
    assert all(len(d["legs"][k]["ranks"]) == 4 for k in "AC")
    assert len(stages) > 20 and all(
        v < out["host"]["mem_total"] for v in stages.values())


def test_phase_wgs_cards_on_four_host_ranks(wgs, monkeypatch):
    """(b) D = 4 in one process: no overflow, the vote launched, 0 oracle
    mismatches over every site, its VCF equal to the hash-table runner's
    and to the JAX single-device runner's;
    (c) four CLI processes: their VCF byte-identical to (b)'s, the vote
    launched in every rank; (d) leg B killed on every rank at a checkpoint
    at or past half the stream, leg C resumed from it and byte-identical
    to leg A; every stage's peak RSS under MemTotal."""
    out, stages, _ = _run_phase(wgs, monkeypatch)
    _check_common(out, stages)
    index = store.load(os.path.join(wgs, "wgs"))
    cfg = rehearse_wgs.geno_config(BATCH)
    with open(os.path.join(wgs, "wgs_cards_b.vcf"), "rb") as f:
        b_vcf = f.read()
    for tag, runner in (
            ("ht", GenoRunner(index, cfg, device="cpu")),
            ("jax", JRunner(jax_view(index), JConfig(
                batch_reads=cfg.batch_reads, max_read_len=cfg.max_read_len,
                max_kmers_per_read=cfg.max_kmers_per_read,
                events_per_read=cfg.events_per_read)))):
        runner.consume_fastq(os.path.join(wgs, "reads.fq"))
        out_vcf = os.path.join(wgs, f"{tag}.vcf")
        runner.write_vcf(os.path.join(wgs, "snps.vcf"), out_vcf)
        with open(out_vcf, "rb") as f:
            assert f.read() == b_vcf, tag


def test_phase_wgs_cards_with_repeats_on_four_host_ranks(wgs_repeats,
                                                        monkeypatch):
    """``--repeats``: all of the above but the JAX runner, on the
    repeat-rich 1 Mb draw; (b)'s first attempt spilled the ambiguous-exact
    capacity and its counts (the whole stream's) equal the JAX sequential
    oracle's at every site; the index holds aux rows, which every card
    holds in ``aux_all``; every rank of (c) and of legs A and C of (d)
    escalated as often as the others, at least once."""
    out, stages, (rc, ac) = _run_phase(wgs_repeats, monkeypatch, DUP_SHARE)
    index = store.load(os.path.join(wgs_repeats, "wgs"))
    pos = index.sites.pos
    # a SNP seeds a site only through an unambiguous SNP-dictionary row
    assert 0.99 * SNPS <= pos.shape[0] <= SNPS
    _check_common(out, stages, pos.shape[0])
    b, c, d = out["b"], out["c"], out["d"]
    assert out["dup_share"] == DUP_SHARE
    assert b["first_amb_overflow"] > 0 and b["escalations"] > 0
    assert b["n_ref_aux"] > 1000 and b["snp_aux_rows"] > 0
    assert list(b["card_aux_bytes"].values()) == [
        80 * (b["n_ref_aux"] + b["snp_aux_rows"])]
    for ranks in (c["ranks"], d["legs"]["A"]["ranks"],
                  d["legs"]["C"]["ranks"]):
        esc = {r["escalations"] for r in ranks}
        assert len(esc) == 1 and esc.pop() > 0, ranks
        assert all(r["aux_bytes"] == b["card_aux_bytes"] for r in ranks)
    oracle = JOracle(jax_view(index))
    oracle.run_fastq(os.path.join(wgs_repeats, "reads.fq"))
    mc = oracle.config.max_cov
    for got, col in ((rc, 4), (ac, 5)):
        want = np.array([oracle.pileup[int(p)][col] for p in pos])
        assert want.sum() > 0
        np.testing.assert_array_equal(np.minimum(got[:pos.shape[0]], mc),
                                      want)
