"""A run end to end on the CPU through the harness's own functions (the
command itself stops without a card): the window, the reference's
verdict, every end-to-end and host-side metric reader; and the faults and
the control that the verdict has to catch."""

import time

import pytest

from genobench import run
from genobench.reference import check
from genobench.tests.tiny import CELLS, SITES, tiny_cell

import vargeno_tpu_torch.engine.geno as geno


def measure(cell, tmp_path, trace=False, seed=11, n_sites=SITES):
    return run.measure(cell, seed, 0.5, trace, "cpu", str(tmp_path),
                       time.perf_counter(), n_sites)


@pytest.mark.parametrize("name", CELLS)
def test_run_on_cpu(name, tmp_path):
    res = measure(tiny_cell(name), tmp_path, n_sites=check.N_SITES)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert res["checks"] == {k: {"value": 0, "limit": v}
                             for k, v in check.LIMITS.items()}
    # every site of the tiny genome was checked against the reference
    assert res["info"]["sites_checked"] > 1000


def test_traced_run_on_cpu(tmp_path):
    res = measure(tiny_cell(CELLS[-1]), tmp_path, True)
    assert res["correct"] is True
    host_side = {"host.dispatch_share", "host.producer_wait_share",
                 "retry.read_frac", "vcf.share", "setup.index_build_s",
                 "setup.place_s"}
    # the device readers find no device operation on the host
    assert set(res["metrics"]) == host_side
    assert 0.4 < res["metrics"]["retry.read_frac"]["value"] < 0.7
    assert res["device"]["window_s"] > 0
    assert res["device"]["busy_s"] == 0


def broken_step(monkeypatch):
    """A step that returns its state unchanged."""
    from vargeno_tpu_torch.dist.sharding import ShardedGenoRunner

    for cls in (geno.GenoRunner, ShardedGenoRunner):
        def same(self, procs, args, kind, totals, issue=cls._issue):
            rc, ac, keys, vecs = issue(self, procs, args, kind, totals)
            return totals[0], totals[1], keys, vecs

        monkeypatch.setattr(cls, "_issue", same)


def half_batch(monkeypatch):
    """Half of every batch left out: its reads carry no k-mer."""
    batches = geno.iter_read_batches

    def half(*a, **kw):
        for b in batches(*a, **kw):
            b.n_kmers[b.n_valid // 2:b.n_valid] = 0
            yield b

    monkeypatch.setattr(geno, "iter_read_batches", half)


def altered_answer(monkeypatch):
    """Every seventh call's GQ altered where the calls are made."""
    calls = geno.GenoRunner.calls

    def altered(self):
        out = calls(self)
        for i, k in enumerate(sorted(out)):
            if i % 7 == 0:
                out[k] = (out[k][0], out[k][1] + 1)
        return out

    monkeypatch.setattr(geno.GenoRunner, "calls", altered)


@pytest.mark.parametrize("fault", [broken_step, half_batch, altered_answer])
@pytest.mark.parametrize("name", CELLS)
def test_faults_fail(name, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    res = measure(tiny_cell(name), tmp_path)
    assert res["correct"] is False
    assert max(v["value"] - v["limit"] for v in res["checks"].values()) > 0


@pytest.mark.parametrize("name", CELLS)
def test_controls_fail(name, tmp_path):
    from genobench import control

    out = control.controls(tiny_cell(name), 5, str(tmp_path), SITES)
    # the reference without its neighbour search is told apart
    assert out["neighbors_off"]["count_sites"] > 0
    assert out["neighbors_off"]["vcf_sites"] > 0
    # float32 calls differ only above 70 reads a site: not at 6X
    assert out["float32_calls"] == {"vcf_sites": 0, "count_sites": 0}
