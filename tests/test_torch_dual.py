"""The dual-orientation step: the port's ``dual_enc`` against the JAX
``make_batch_processor(dix, cfg).raw_enc`` (jitted here) on the same
pre-encoded mini reads -- counts and every stat key, exactly -- at default
capacities and at capacities small enough to trip every overflow counter
in both passes; ``dual`` (device-side encode) against ``dual_enc``; and the
escalation of a prefixed overflow key. The index is the mini fixture's at a
small Bloom geometry (both packages read the same arrays)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_index_share import FIX, small_index

from vargeno_tpu.config import GenoConfig as JConfig
from vargeno_tpu.engine.batch import make_batch_processor as j_make
from vargeno_tpu.engine.device_index import build_device_index as j_build
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.core.kmer import np_encode_batch
from vargeno_tpu_torch.engine import device_index as tdi
from vargeno_tpu_torch.engine.batch import (PORT_ONLY_STATS,
                                          make_batch_processor)
from vargeno_tpu_torch.engine.geno import (_escalate_config,
                                         _strip_orientation)
from vargeno_tpu_torch.io.fastq import iter_read_batches

torch.set_num_threads(2)

B, L, K = 512, 128, 4
N_BATCHES = 3

SHRUNK = {
    "shrunk_events": dict(
        events_per_read=3, candidates_per_read=1, agree_cap=1,
        sites_per_context=1, neighbor_item_frac=0.03,
        probe_active_frac=0.01),
    "shrunk_probes": dict(
        batch_reads=4096, probe_hit_cap=1, scan_slot_cap=1,
        scan_active_frac=0.01, sparse_events_frac=0.0001),
}
# each per-pass counter must fire in the forward AND the reverse pass
TRIPS = {
    "default": set(),
    "shrunk_events": {"fwd_ni_overflow", "rev_ni_overflow",
                      "fwd_event_overflow", "rev_event_overflow",
                      "fwd_cand_overflow", "rev_cand_overflow",
                      "agree_overflow", "site_slot_overflow",
                      "act_overflow"},
    "shrunk_probes": {"fwd_probe_overflow", "rev_probe_overflow",
                      "fwd_snp_scan_overflow", "rev_snp_scan_overflow",
                      "fwd_sev_overflow", "rev_sev_overflow"},
}


@pytest.fixture(scope="module")
def indexes():
    index = small_index()
    load = JConfig().ht_target_load
    jdix = j_build(index, ht_target_load=load)
    host = j_build(index, host_only=True, ht_target_load=load)
    tdix = tdi.from_numpy({f: getattr(host, f) for f in tdi.DEVICE_FIELDS},
                          {f: getattr(host, f) for f in tdi.STATIC_FIELDS},
                          "cpu")
    return jdix, tdix


def _batches(n_reads):
    out = []
    for b in iter_read_batches(os.path.join(FIX, "reads.fq"), n_reads, L,
                               K):
        out.append((b, np_encode_batch(b.codes, b.n_kmers, K)))
        if len(out) == N_BATCHES:
            break
    return out


def _torch_enc(enc):
    hi, lo, kv, rok = enc
    return (torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(kv),
            torch.from_numpy(rok))


@pytest.mark.parametrize("caps", sorted(TRIPS))
def test_dual_step_matches_jax(indexes, caps):
    jdix, tdix = indexes
    kw = dict(batch_reads=B, max_read_len=L, max_kmers_per_read=K)
    kw.update(SHRUNK.get(caps, {}))
    jstep = jax.jit(j_make(jdix, JConfig(**kw)).raw_enc)
    tproc = make_batch_processor(tdix, GenoConfig(**kw))
    n = tdix.n_sites + 1
    j_rc = j_ac = jnp.zeros(n, jnp.int32)
    t_rc = t_ac = torch.zeros(n, dtype=torch.int32)
    tripped = set()
    for b, enc in _batches(kw["batch_reads"]):
        j_rc, j_ac, js = jstep(
            jdix, *(jnp.asarray(a) for a in enc), jnp.asarray(b.n_kmers),
            jnp.asarray(b.qual), j_rc, j_ac)
        t_rc, t_ac, ts = tproc.dual_enc(
            *_torch_enc(enc), torch.from_numpy(b.n_kmers),
            torch.from_numpy(b.qual), t_rc, t_ac)
        np.testing.assert_array_equal(t_rc.numpy(), np.asarray(j_rc))
        np.testing.assert_array_equal(t_ac.numpy(), np.asarray(j_ac))
        # the port's own stats: on this input nothing spills
        port_only = {k: int(v) for k, v in ts.items()
                     if _strip_orientation(k) in PORT_ONLY_STATS}
        assert not any(v for k, v in port_only.items() if "overflow" in k)
        ts = {k: v for k, v in ts.items() if k not in port_only}
        assert sorted(ts) == sorted(js)
        got = {k: int(v) for k, v in ts.items()}
        want = {k: int(v) for k, v in js.items()}
        assert got == want
        tripped |= {k for k, v in got.items() if "overflow" in k and v}
        assert got["n_processed"] > 0
        # the telemetry auto-tune reads, with and without a prefix
        for key in ("fwd_ev_max", "rev_lowq_n", "fwd_probe_lanes_max",
                    "act_lanes_max", "ref_scan_lanes_max",
                    "snp_scan_lanes_max", "agree_lanes_max"):
            assert key in got
    assert tripped >= TRIPS[caps], tripped
    if caps == "default":
        assert not tripped
    assert int(t_rc.sum()) > 0


def test_dual_from_codes_equals_dual_enc(indexes):
    """``dual`` encodes the base codes on the device; its result equals
    ``dual_enc`` on the host-encoded words."""
    _, tdix = indexes
    cfg = GenoConfig(batch_reads=B, max_read_len=L, max_kmers_per_read=K)
    proc = make_batch_processor(tdix, cfg)
    n = tdix.n_sites + 1
    z = torch.zeros(n, dtype=torch.int32)
    b, enc = _batches(B)[1]
    nk, qual = torch.from_numpy(b.n_kmers), torch.from_numpy(b.qual)
    rc1, ac1, s1 = proc.dual_enc(*_torch_enc(enc), nk, qual, z, z)
    rc2, ac2, s2 = proc.dual(torch.from_numpy(b.codes), nk, qual, z, z)
    assert torch.equal(rc1, rc2) and torch.equal(ac1, ac2)
    assert {k: int(v) for k, v in s1.items()} \
        == {k: int(v) for k, v in s2.items()}
    assert int(rc1.sum()) > 0 and int(z.sum()) == 0   # inputs untouched


def test_escalate_config_strips_orientation_prefix():
    cfg = GenoConfig(events_per_read=6, candidates_per_read=4,
                     probe_hit_cap=4, neighbor_item_frac=0.004)
    up = _escalate_config(cfg, ["fwd_event_overflow", "rev_cand_overflow",
                                "rev_probe_overflow", "fwd_ni_overflow",
                                "agree_overflow"])
    assert (up.events_per_read, up.candidates_per_read) == (12, 8)
    assert up.probe_hit_cap == 8 and up.neighbor_item_frac == 0.008
    assert up.agree_cap == 2 * cfg.agree_cap
    # both passes tripping the same cap double it once
    both = _escalate_config(cfg, ["fwd_event_overflow",
                                  "rev_event_overflow"])
    assert both.events_per_read == 24
