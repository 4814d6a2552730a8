"""Port tests that need the card: each kernel against its plain version, the
batch steps on CUDA against the same steps on the CPU, and the runner's
modes on CUDA against the CPU runner. They import no JAX, so they run on a
machine without it:

    python -m pytest tests/test_torch_gpu.py -q

Each skips itself where there is no CUDA device."""

import os

import numpy as np
import pytest
import torch
from torch_index_share import FIX
from torch_index_share import small_index as build_small_index

from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.core.kmer import np_encode_batch
from vargeno_tpu_torch.dist.sharded_dict import ShardedDictGenoRunner
from vargeno_tpu_torch.dist.sharding import ShardedGenoRunner, make_mesh
from vargeno_tpu_torch.engine import device_index as tdi
from vargeno_tpu_torch.engine import search
from vargeno_tpu_torch.engine.batch import make_batch_processor
from vargeno_tpu_torch.engine.cohort import CohortRunner
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.io.fastq import iter_read_batches
from vargeno_tpu_torch.kernels import gather as gather_mod
from vargeno_tpu_torch.kernels import vote as vote_mod
from vargeno_tpu_torch.kernels.gather import (gather_rows_sum,
                                              gather_rows_sum_plain)
from vargeno_tpu_torch.kernels.vote import (vote_scan, vote_scan_plain,
                                            vote_scan_records,
                                            vote_scan_records_plain)
from vargeno_tpu_torch.tools import fuzz_diff
from vargeno_tpu_torch.tools.bench_gather import bench

torch.set_num_threads(2)
pytestmark = pytest.mark.gpu


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


def _records(E, B, C, seed, pad, dev):
    """The events of ``_events`` packed as the step packs them: (B, E) views
    of (B, E + pad)-strided int64 words, junk in the padding, ``src`` bits
    above bit 7 of meta, counts of full reads running past E."""
    idx, k, isnb, valid, ev_n = _events(E, B, C, seed)
    rng = np.random.default_rng(seed + 1)
    rec_idx = torch.from_numpy(rng.integers(0, 2**32, (B, E + pad)))
    rec_meta = torch.from_numpy(rng.integers(0, 2**32, (B, E + pad)))
    rec_idx[:, :E] = idx.t()
    rec_meta[:, :E] = (k.t().long() | (isnb.t().long() << 5)
                       | (valid.t().long() << 6)
                       | torch.from_numpy(rng.integers(0, 2**25, (B, E)) << 7))
    total = ev_n.long()
    total[total == E] += 7
    return ((idx, k, isnb, valid, ev_n),
            (rec_idx.to(dev)[:, :E], rec_meta.to(dev)[:, :E], total.to(dev)))


# launched widths min(C, E) = 8, 16, 32, 64, 512, 1024: 8 lanes a read x 1
# and 2 slots, the width-32 choice, 32 lanes x 2 and 16 register slots, and
# the global-workspace table; B off the multiples of the reads a warp
@pytest.mark.parametrize("E,B,C", [(8, 4099, 32), (16, 1001, 16),
                                   (96, 4097, 32), (96, 4096, 64),
                                   (600, 511, 512), (1200, 510, 1024),
                                   (3, 33, 1), (40, 5, 4)])
def test_vote_records_kernel_matches_plain(cuda, E, B, C):
    quartet, records = _records(E, B, C, C + E, pad=1, dev=cuda)
    assert records[0].stride() == (E + 1, 1)
    before = vote_scan_records.launches
    got = vote_scan_records(*records, C)
    torch.cuda.synchronize()
    assert vote_scan_records.launches == before + 1
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int64
    assert got[2].dtype == torch.int64 and got[2].shape == ()
    want = vote_scan_records_plain(*(t.cpu() for t in records), C)
    via_eb = vote_scan(*(t.to(cuda) for t in quartet[:4]), C,
                       quartet[4].to(cuda))
    for a, b, c in zip(got, want, via_eb):
        assert torch.equal(a.cpu(), b)
        assert torch.equal(c.cpu(), b)
    if (E, C) == (40, 4):
        assert int(got[2]) > 0


# every table the launcher can pick: 8 lanes x 1 and 2 slots, 32 lanes x 1,
# 2, 4, 8 and 16 slots, the global workspace; a row stride well off E
@pytest.mark.parametrize("E,B,C", [(8, 4099, 8), (96, 1000, 7),
                                   (16, 1001, 16), (96, 4097, 32),
                                   (96, 1003, 64), (200, 515, 128),
                                   (300, 509, 256), (600, 255, 512),
                                   (700, 130, 1024)])
def test_vote_bare_launch_matches_plain(cuda, E, B, C):
    """The bare launch (what the smoke run times as the kernel's own) at
    each table the launcher picks by width."""
    _, records = _records(E, B, C, 3 * C + E, pad=5, dev=cuda)
    assert records[0].stride() == (E + 5, 1)
    width = min(C, E)
    process = torch.empty(B, dtype=torch.bool, device=cuda)
    target = torch.empty(B, dtype=torch.int64, device=cuda)
    ovf = torch.zeros((), dtype=torch.int64, device=cuda)
    ws = None
    if width > vote_mod.load_library().vgt_vote_reg_max_c():
        ws = torch.empty((3, B, width), dtype=torch.int32, device=cuda)
    vote_mod.launch_records(*records, width, process, target, ovf, ws)
    torch.cuda.synchronize()
    want = vote_scan_records_plain(*(t.cpu() for t in records), C)
    for a, b in zip((process, target, ovf), want):
        assert torch.equal(a.cpu(), b)


def test_vote_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    _, (idx, meta, total) = _records(8, 64, 4, 1, pad=1, dev=cuda)
    before = vote_scan_records.launches
    with pytest.raises(ValueError):
        vote_scan_records(idx, meta, total, 0)
    with pytest.raises(TypeError):
        vote_scan_records(idx.int(), meta, total, 4)
    with pytest.raises(ValueError):
        vote_scan_records(idx.t().contiguous().t(), meta, total, 4)
    with pytest.raises(ValueError):
        vote_scan_records(idx, meta.contiguous(), total, 4)
    with pytest.raises(ValueError):
        vote_scan_records(idx, meta, total.cpu(), 4)
    with pytest.raises(ValueError):
        vote_scan_records(idx, meta, total[:63], 4)
    assert vote_scan_records.launches == before
    empty = vote_scan_records(idx[:0], meta[:0], total[:0], 4)
    assert empty[0].shape == (0,) and int(empty[2]) == 0
    assert vote_scan_records.launches == before


# the wrapper on both sides of the library's choice (the ring from 2**17
# rows of 128 B up, the direct kernel below that and at every other width):
# N off the multiples of 32, W = 32 / 64 / 96 / 128 / 160 / 256, every
# index equal
@pytest.mark.parametrize("N,R,W,same", [
    (65536, 1 << 18, 32, False), (1 << 20, 1 << 18, 32, False),
    (1 << 17, 1 << 16, 128, False), (5000, 4096, 96, False),
    (100000, 1 << 18, 32, True), (1, 4096, 32, False),
    (33, 7, 256, False), (5, 4096, 32, False), (77, 4096, 64, False),
    (1200003, 1 << 18, 32, False), (100001, 1 << 14, 64, False),
    (70001, 1 << 14, 128, False), (5000, 4096, 160, False),
    (1 << 21, 1 << 18, 32, True)])
def test_gather_kernel_matches_plain(cuda, N, R, W, same):
    rng = np.random.default_rng(N + W)
    table = torch.from_numpy(rng.integers(
        0, 2**32, (R, W), dtype=np.uint32).view(np.int32)).to(cuda)
    idx = rng.integers(0, R, N, dtype=np.int64)
    if same:
        idx[:] = idx[0]
    for dtype in (torch.int32, torch.int64):
        ix = torch.from_numpy(idx).to(cuda).to(dtype)
        before = gather_rows_sum.launches
        got = gather_rows_sum(table, ix)
        torch.cuda.synchronize()
        assert gather_rows_sum.launches == before + 1
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(gather_rows_sum_plain(table, ix))
        assert int(got) == int(gather_rows_sum_plain(table.cpu(), ix.cpu()))


# N below one stage (32 rows), below the ring's depth (64 rows a warp), off
# the multiples of 32; every width the ring takes; every index equal
@pytest.mark.parametrize("N,R,W,same", [
    (1 << 18, 1 << 16, 32, False), (40001, 4096, 128, False),
    (999, 512, 64, False), (3, 64, 32, False), (33, 64, 128, False),
    (50, 64, 32, False), (1000003, 1 << 18, 32, False),
    (100001, 1 << 14, 64, False), (100000, 1 << 14, 32, True)])
def test_gather_ring_and_direct_kernels_match_plain(cuda, N, R, W, same):
    """Each kernel named outright through the bare launch, whatever the
    library would pick at the shape."""
    rng = np.random.default_rng(N)
    table = torch.from_numpy(rng.integers(
        0, 2**32, (R, W), dtype=np.uint32).view(np.int32)).to(cuda)
    idx = rng.integers(0, R, N, dtype=np.int64)
    if same:
        idx[:] = idx[0]
    for dtype in (torch.int32, torch.int64):
        ix = torch.from_numpy(idx).to(cuda).to(dtype)
        want = int(gather_rows_sum_plain(table, ix))
        for kernel in ("ring", "direct", "chosen"):
            out = torch.zeros((), dtype=torch.int32, device=cuda)
            gather_mod.launch(table, ix, out, kernel)
            torch.cuda.synchronize()
            assert int(out) == want, kernel


def test_gather_ring_refuses_rows_wider_than_a_slot(cuda):
    table = torch.zeros((64, 160), dtype=torch.int32, device=cuda)
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    out = torch.zeros((), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError):
        gather_mod.launch(table, idx, out, "ring")
    gather_mod.launch(table, idx, out, "direct")
    torch.cuda.synchronize()
    assert int(out) == 0


def test_gather_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    table = torch.zeros((64, 32), dtype=torch.int32, device=cuda)
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    before = gather_rows_sum.launches
    with pytest.raises(TypeError):
        gather_rows_sum(table.long(), idx)
    with pytest.raises(TypeError):
        gather_rows_sum(table, idx.to(torch.int16))
    with pytest.raises(TypeError):
        gather_rows_sum(table, idx.reshape(2, 4))
    with pytest.raises(ValueError):
        gather_rows_sum(table[:, :24].contiguous(), idx)
    with pytest.raises(ValueError):
        gather_rows_sum(table, idx.cpu())
    with pytest.raises(ValueError):
        gather_rows_sum(table.t().contiguous().t(), idx)
    flat = torch.zeros(64 * 32 + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):   # rows 4 B off a 16 B boundary
        gather_rows_sum(flat[1:].view(64, 32), idx)
    assert gather_rows_sum.launches == before
    empty = gather_rows_sum(table, idx[:0])
    assert int(empty) == 0 and gather_rows_sum.launches == before


def test_bench_runs_small_on_cuda(cuda):
    before = gather_rows_sum.launches
    out = bench(cuda, table_mb=8, shrink=16, reps=2, verbose=False)
    assert out["device"] == torch.cuda.get_device_name(cuda)
    assert gather_rows_sum.launches > before
    assert out["kernel_row_gather_512B"] is None \
        or out["kernel_row_gather_512B"] > 0


@pytest.fixture(scope="module")
def small_index():
    """The mini fixture's index at a small Bloom geometry."""
    return build_small_index()


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
        before = vote_scan_records.launches
        run.consume_fastq(fq)
        assert vote_scan_records.launches > before
        got = run.host_counts()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert run.n_retry_reads == ref.n_retry_reads


def test_dual_step_on_cuda_matches_cpu(cuda, small_index):
    """The dual-orientation step on the card equals the CPU step."""
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
                     b.n_kmers, b.qual)]
            rc, ac, st = proc.dual_enc(*args, rc, ac)
            res.append({k: int(v) for k, v in st.items()})
            if i == 1:
                break
        outs.append((rc.cpu(), ac.cpu(), res))
    (c_rc, c_ac, c_res), (g_rc, g_ac, g_res) = outs
    assert torch.equal(c_rc, g_rc) and torch.equal(c_ac, g_ac)
    assert c_res == g_res
    assert int(g_rc.sum()) > 0


def test_runner_modes_on_cuda_match_cpu(cuda, small_index, tmp_path):
    """Non-queued, auto-tuned, checkpoint-resumed and cohort runs on the
    card count exactly as the queued CPU runner at defaults."""
    base = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
    fq = os.path.join(FIX, "reads.fq")
    ref = GenoRunner(small_index, GenoConfig(**base), device="cpu")
    ref.consume_fastq(fq)
    want = ref.host_counts()
    dix = tdi.build_device_index(small_index, cuda, 0.24)

    def check(run):
        got = run.host_counts()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

    before = vote_scan_records.launches
    dual = GenoRunner(small_index, GenoConfig(**base), device=cuda, dix=dix,
                      queued_orientation=False)
    dual.consume_fastq(fq)
    check(dual)
    tuned = GenoRunner(small_index, GenoConfig(**base, auto_tune=True,
                                               tune_batches=3),
                       device=cuda, dix=dix)
    tuned.consume_fastq(fq)
    check(tuned)
    assert tuned._cfg_run.events_per_read < 96
    ck = str(tmp_path / "ck")
    first = GenoRunner(small_index, GenoConfig(**base), device=cuda, dix=dix)
    first.consume_fastq(fq, limit_batches=8, checkpoint_path=ck,
                        checkpoint_every=4)
    second = GenoRunner(small_index, GenoConfig(**base), device=cuda,
                        dix=dix)
    second.consume_fastq(fq, checkpoint_path=ck)
    assert 0 < first.n_reads < second.n_reads == ref.n_reads
    check(second)
    cohort = CohortRunner(small_index, ["a", "b"], GenoConfig(**base),
                          device=cuda)
    cohort.consume_sample("a", fq)
    cohort.consume_sample("b", fq, limit_batches=2)
    a_rc, a_ac = (t.cpu().numpy() for t in cohort.counts["a"])
    np.testing.assert_array_equal(a_rc, want[0])
    np.testing.assert_array_equal(a_ac, want[1])
    assert int(cohort.counts["b"][0].sum()) < int(a_rc.sum())
    assert vote_scan_records.launches > before


def test_search_on_cuda_matches_cpu(cuda):
    """The sorted search over int64 keys on the card, queries at the word
    limits included."""
    rng = np.random.default_rng(5)
    k = np.sort(rng.integers(0, 2**63, 100000, dtype=np.uint64) * 2)
    hi = (k >> np.uint64(32)).astype(np.uint32)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    keys = torch.from_numpy(search.np_okey(hi, lo))
    qh = torch.from_numpy(rng.integers(0, 2**32, 5000).astype(np.int64))
    ql = torch.from_numpy(rng.integers(0, 2**32, 5000).astype(np.int64))
    qh[:2], ql[:2] = 0xFFFFFFFF, 0xFFFFFFFF
    want = search.lower_bound(keys, qh, ql)
    got = search.lower_bound(keys.to(cuda), qh.to(cuda), ql.to(cuda))
    assert torch.equal(got.cpu(), want)
    end = search.block_end(keys.to(cuda), qh.to(cuda))
    assert torch.equal(end.cpu(), search.block_end(keys, qh))


@pytest.mark.parametrize("dtype,n", [(np.int32, (1 << 26) + 7),
                                     (np.int64, 3 * (1 << 25) + 1),
                                     (np.int32, 0), (np.uint8, 13)])
def test_upload_array_in_pinned_chunks(cuda, monkeypatch, dtype, n):
    """The staged upload over several chunks (a small stage), with a last
    chunk of odd size, from a read-only array too, bit for bit."""
    monkeypatch.setattr(tdi, "STAGE_BYTES", 1 << 24)
    rng = np.random.default_rng(n)
    a = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, n,
                     dtype=dtype)
    a.flags.writeable = False
    got = tdi.upload_array(a, cuda)
    assert got.device.type == "cuda" and got.shape == a.shape
    assert np.array_equal(got.cpu().numpy(), a)
    if dtype == np.int32:   # a uint32 table: the same bits, as int32
        t = tdi._to_device(a.view(np.uint32).reshape(-1, 1), cuda)
        assert t.dtype == torch.int32 and t.shape == (n, 1)
        assert np.array_equal(t.cpu().numpy().ravel(), a)


def test_make_mesh_refuses_more_than_visible_gpus(cuda):
    n = torch.cuda.device_count()
    assert make_mesh(n).devices == [torch.device(f"cuda:{i}")
                                    for i in range(n)]
    with pytest.raises(ValueError, match="CUDA device"):
        make_mesh(n + 1)


def test_mesh_runners_on_cuda_match_cpu(cuda, small_index):
    """Both mesh runners at D = 2 on the card (cuda:0 named twice when one
    card is visible: a check of the routing, not a deployment), the routed
    one also escalating from a tiny route_factor, count exactly as the CPU
    GenoRunner, with the vote kernel launched."""
    base = dict(batch_reads=512, max_read_len=128, max_kmers_per_read=4)
    fq = os.path.join(FIX, "reads.fq")
    ref = GenoRunner(small_index, GenoConfig(**base), device="cpu")
    ref.consume_fastq(fq)
    want = ref.host_counts()
    devs = [f"cuda:{i % torch.cuda.device_count()}" for i in range(2)]
    for cls, kw in ((ShardedGenoRunner, {}), (ShardedDictGenoRunner, {}),
                    (ShardedDictGenoRunner, dict(route_factor=0.05))):
        before = vote_scan_records.launches
        run = cls(small_index, make_mesh(devices=devs),
                  GenoConfig(**base, **kw))
        run.consume_fastq(fq)
        assert vote_scan_records.launches > before
        got = run.host_counts()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert not {k: v for k, v in run.stats_totals.items()
                    if "overflow" in k and v}
        if kw:
            assert run._cfg_run.route_factor > kw["route_factor"]


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_seed_on_cuda_matches_oracle(cuda, seed, tmp_path):
    """The differential fuzzer's seed on the card: counts equal to the
    sequential oracle's at every site, no overflow left, the vote kernel
    launched."""
    got = fuzz_diff.run_seed(seed, "cuda", tmpdir=str(tmp_path))
    assert got["ok"] and not got["overflow"], got
    assert got["vote_launches"] > 0
