"""Port tests that need the card: the vote kernel against its plain version,
and the whole batch step on CUDA against the same step on the CPU. They
import no JAX, so they run on a machine without it:

    python -m pytest tests/test_torch_gpu.py -q

Each skips itself where there is no CUDA device."""

import os

import numpy as np
import pytest
import torch

from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.core.kmer import np_encode_batch
from vargeno_tpu_torch.engine import device_index as tdi
from vargeno_tpu_torch.engine.batch import make_batch_processor
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.index import bloom, dictgen, store
from vargeno_tpu_torch.io import fasta as fasta_io
from vargeno_tpu_torch.io.fastq import iter_read_batches
from vargeno_tpu_torch.kernels.vote import vote_scan, vote_scan_plain

torch.set_num_threads(2)
pytestmark = pytest.mark.gpu

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "mini")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _events(E, B, C, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2 * C, (E, B)).astype(np.int64)
    idx[rng.random((E, B)) < 0.05] |= 1 << 31
    k = rng.integers(0, 4, (E, B)).astype(np.int32)
    isnb = rng.random((E, B)) < 0.3
    ev_n = rng.integers(0, E + 1, B).astype(np.int32)
    valid = (rng.random((E, B)) < 0.8) & (np.arange(E)[:, None]
                                          < ev_n[None, :])
    return [torch.from_numpy(a) for a in (idx, k, isnb, valid, ev_n)]


# C > E launches min(C, E) slots; C > 512 (here 1024 and 520, wide enough
# for > 512 inserts in the longest reads) takes the global-workspace table
@pytest.mark.parametrize("E,B,C", [(96, 4096, 32), (96, 4096, 64),
                                   (32, 4096, 16), (40, 1000, 128),
                                   (3, 33, 1), (40, 1000, 256),
                                   (300, 512, 256), (600, 512, 512),
                                   (1200, 512, 1024), (2000, 256, 520)])
def test_vote_kernel_matches_plain(cuda, E, B, C):
    idx, k, isnb, valid, ev_n = (t.to(cuda) for t in _events(E, B, C, C))
    before = vote_scan.launches
    got = vote_scan(idx, k, isnb, valid, C, ev_n)
    torch.cuda.synchronize()
    assert vote_scan.launches == before + 1
    want = vote_scan_plain(idx, k, isnb, valid, C, ev_n)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    if (E, C) == (2000, 520):
        assert int(got[2]) > 0


@pytest.fixture(scope="module")
def small_index():
    """The mini fixture's index at a small Bloom geometry."""
    seqs = fasta_io.parse_fasta(os.path.join(FIX, "genome.fa"))
    vcf = os.path.join(FIX, "snps.vcf")
    ref_bf, _ = bloom.build_ref_bfs(seqs, 1 << 24, 64)
    snp_dict, locs = dictgen.build_snp_dict_from_vcf(seqs, vcf)
    ref_dict, _ = dictgen.build_ref_dict(seqs)
    return store.VarGenoIndex(
        ref=ref_dict, snp=snp_dict, ref_bf=ref_bf,
        snp_bf=bloom.build_snp_bf(seqs, vcf, 1 << 20),
        chrlens=[(s.name, s.size) for s in seqs],
        sites=store.derive_sites(snp_dict), snp_locations=locs)


def test_step_on_cuda_matches_cpu(cuda, small_index):
    """The whole single-orientation step (lookups, scans, compactions with
    sink slots, the vote kernel, the pileup) on the card equals the CPU
    step, on mini reads at a small Bloom geometry."""
    fields, statics = tdi.host_fields(small_index, 0.24)
    B, L, K = 1024, 128, 4
    cfg = GenoConfig(batch_reads=B, max_read_len=L, max_kmers_per_read=K)
    outs = []
    for dev in ("cpu", cuda):
        proc = make_batch_processor(tdi.from_numpy(fields, statics, dev), cfg)
        n = proc.dix.n_sites + 1
        rc = ac = torch.zeros(n, dtype=torch.int32, device=dev)
        res = []
        for i, b in enumerate(iter_read_batches(
                os.path.join(FIX, "reads.fq"), B, L, K)):
            hi, lo, kv, rok = np_encode_batch(b.codes, b.n_kmers, K)
            args = [torch.from_numpy(a).to(dev) for a in
                    (hi.astype(np.int64), lo.astype(np.int64), kv, rok,
                     b.qual)]
            rc, ac, p, r, st = proc.single_enc(*args, rc, ac)
            res.append((p.cpu(), r.cpu(),
                        {k: int(v) for k, v in st.items()}))
            if i == 2:
                break
        outs.append((rc.cpu(), ac.cpu(), res))
    (c_rc, c_ac, c_res), (g_rc, g_ac, g_res) = outs
    assert torch.equal(c_rc, g_rc) and torch.equal(c_ac, g_ac)
    for (p1, r1, s1), (p2, r2, s2) in zip(c_res, g_res):
        assert torch.equal(p1, p2) and torch.equal(r1, r2)
        assert s1 == s2
    assert int(g_rc.sum()) > 0


def test_runner_on_cuda_with_wide_candidate_tables(cuda, small_index):
    """GenoRunner on the card with the candidate tables that overflow
    escalation reaches past 128 slots (register table at 192, global
    workspace at 640) counts exactly as the CPU runner at defaults."""
    base = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
    fq = os.path.join(FIX, "reads.fq")
    ref = GenoRunner(small_index, GenoConfig(**base), device="cpu")
    ref.consume_fastq(fq)
    want = ref.host_counts()
    for E, C in ((192, 256), (640, 1024)):
        cfg = GenoConfig(**base, events_per_read=E, candidates_per_read=C)
        run = GenoRunner(small_index, cfg, device=cuda)
        before = vote_scan.launches
        run.consume_fastq(fq)
        assert vote_scan.launches > before
        got = run.host_counts()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert run.n_retry_reads == ref.n_retry_reads
