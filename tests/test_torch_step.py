"""One batch step: the port's ``single_enc`` against the JAX
``make_batch_processor(dix, cfg).single_enc`` on the same pre-encoded mini
reads -- counts, process, read_ok and every stat key, exactly -- at default
capacities and at capacities small enough to trip every overflow counter.
The index is the mini fixture's at a small Bloom geometry (both packages
read the same arrays), so the file holds no 1.2 GB ref Bloom filter."""

import os

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
from vargeno_tpu_torch.engine.geno import _strip_orientation
from vargeno_tpu_torch.io.fastq import iter_read_batches

torch.set_num_threads(2)

B, L, K = 512, 128, 4
N_BATCHES = 3

# capacities small enough to trip the counters: the first set starves the
# event, candidate and pileup stages, the second the probe stages
SHRUNK = {
    "shrunk_events": dict(
        events_per_read=3, candidates_per_read=1, agree_cap=1,
        sites_per_context=1, neighbor_item_frac=0.03,
        probe_active_frac=0.01),
    "shrunk_probes": dict(
        batch_reads=4096, probe_hit_cap=1, scan_slot_cap=1,
        scan_active_frac=0.01, sparse_events_frac=0.0001),
}
TRIPS = {
    "default": set(),
    "shrunk_events": {"ni_overflow", "event_overflow", "cand_overflow",
                      "agree_overflow", "site_slot_overflow",
                      "act_overflow"},
    "shrunk_probes": {"probe_overflow", "snp_scan_overflow",
                      "sev_overflow"},
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
        out.append((np_encode_batch(b.codes, b.n_kmers, K), b.qual))
        if len(out) == N_BATCHES:
            break
    return out


@pytest.mark.parametrize("caps", sorted(TRIPS))
def test_step_matches_jax(indexes, caps):
    jdix, tdix = indexes
    kw = dict(batch_reads=B, max_read_len=L, max_kmers_per_read=K)
    kw.update(SHRUNK.get(caps, {}))
    jproc = j_make(jdix, JConfig(**kw))
    tproc = make_batch_processor(tdix, GenoConfig(**kw))
    n = tdix.n_sites + 1
    j_rc = j_ac = jnp.zeros(n, jnp.int32)
    t_rc = t_ac = torch.zeros(n, dtype=torch.int32)
    tripped = set()
    for (hi, lo, kv, rok), qual in _batches(kw["batch_reads"]):
        j_rc, j_ac, jp, jr, js = jproc.single_enc(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(kv),
            jnp.asarray(rok), jnp.asarray(qual), j_rc, j_ac)
        t_rc, t_ac, tp, tr, ts = tproc.single_enc(
            torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(kv),
            torch.from_numpy(rok), torch.from_numpy(qual), t_rc, t_ac)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
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
    assert tripped >= TRIPS[caps], tripped
    if caps == "default":
        assert not tripped
    assert int(t_rc.sum()) > 0
